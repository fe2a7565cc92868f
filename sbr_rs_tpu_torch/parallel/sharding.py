"""Which parameters are sharded, and the row traffic of a sharded table.
Counterpart of :mod:`sbr_rs_tpu.parallel.sharding`.

Rule set (the JAX package's):

* ``item_table`` (the fused embedding + bias table) and its optimizer-state
  leaves — row-sharded over the ``model`` axis: slab ``m`` holds rows
  ``[m * n_loc, min((m + 1) * n_loc, N))``, ``n_loc = ceil(N / model)``;
* the tower, ``alpha`` and the step counts — replicated;
* batches — split over the ``data`` axis (:func:`batch_slice`,
  :func:`batch_sharding`).

Where XLA turns a gather from a sharded table into collectives, the port
does it by hand (:func:`gather_rows_sharded`): each rank gathers its own
slab's rows with the row kernel (P1), the other rows become ``-0.0``, and
one ``all_reduce`` sums over the model group. ``-0.0`` is the additive
identity of IEEE floats (``x + -0.0 == x`` for every ``x``, ``+0.0`` and
``-0.0`` included), and each row has one owner, so the sum is the owner's
row bit for bit, whatever order the collective adds in. WARP's candidate
scores are summed the same way (:func:`cand_score_sharded`, P3 or P4 on the
slab).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.row_kernels import cand_score, gather_rows
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

_SHARDED_ROW_LEAVES = ("item_table",)


def _map_with_keys(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any, keys: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_keys(fn, v, keys) for v in tree]
    return fn(keys, tree)


def _is_sharded(keys: Tuple[str, ...], leaf: Any) -> bool:
    return bool(set(keys) & set(_SHARDED_ROW_LEAVES)) and getattr(leaf, "ndim", 0) >= 1


def param_specs(tree: Any) -> Any:
    """The partition of each leaf of a parameter or optimizer-state tree, as
    the JAX package's ``PartitionSpec`` tuples: ``("model", None, ...)`` for
    the row-sharded leaves, ``()`` (replicated) for the others."""
    return _map_with_keys(
        lambda keys, x: (MODEL_AXIS,) + (None,) * (x.ndim - 1) if _is_sharded(keys, x) else (), tree
    )


def slab_range(mesh: Optional[Mesh], num_rows: int) -> Tuple[int, int]:
    """``(lo, hi)``: the rows of this rank's slab (all of them without a
    mesh or with ``model == 1``). Raises ``ValueError`` when a slab would be
    empty (fewer rows than the model axis can split)."""
    if mesh is None or mesh.model == 1:
        return 0, num_rows
    n_loc = -(-num_rows // mesh.model)
    if (mesh.model - 1) * n_loc >= num_rows:
        raise ValueError(f"{num_rows} rows leave a slab empty at model={mesh.model}")
    lo = mesh.m * n_loc
    return lo, min(lo + n_loc, num_rows)


def shard_model_params(tree: Any, mesh: Optional[Mesh]) -> Any:
    """``tree`` with each row-sharded leaf cut to this rank's slab (a copy
    of its own, so the whole leaf can be freed); the others unchanged."""
    if mesh is None or mesh.model == 1:
        return tree

    def shard(keys, x):
        if not _is_sharded(keys, x):
            return x
        lo, hi = slab_range(mesh, x.shape[0])
        return x[lo:hi].clone()

    return _map_with_keys(shard, tree)


def batch_slice(mesh: Optional[Mesh], batch_size: int) -> slice:
    """This rank's contiguous share of a batch of ``batch_size`` rows (a
    multiple of ``data``)."""
    if mesh is None or mesh.data == 1:
        return slice(0, batch_size)
    if batch_size % mesh.data:
        raise ValueError(f"a batch of {batch_size} rows does not split over data={mesh.data}")
    b = batch_size // mesh.data
    return slice(mesh.d * b, (mesh.d + 1) * b)


def batch_sharding(mesh: Optional[Mesh], ndim: int = 2) -> Callable[[torch.Tensor], torch.Tensor]:
    """The split of a batch over the ``data`` axis (the JAX package's
    ``NamedSharding(mesh, P("data", None, ...))`` for arrays of ``ndim``
    dimensions): a function that takes the whole batch ``[B, ...]``, the same
    on every rank, and returns this rank's rows of it, the share
    :func:`batch_slice` gives and ``fit`` trains on. Raises ``ValueError``
    for a batch of another rank than ``ndim`` or one that does not split
    evenly."""

    def shard(batch: torch.Tensor) -> torch.Tensor:
        if batch.ndim != ndim:
            raise ValueError(f"a batch sharding for {ndim} dimensions got {batch.ndim}")
        return batch[batch_slice(mesh, batch.shape[0])]

    return shard


def to_local(ids: torch.Tensor, lo: int, hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids - lo, in_slab)``: slab-local ids (out of range where
    ``in_slab`` is false) and which ids the slab ``[lo, hi)`` owns."""
    return ids - lo, (ids >= lo) & (ids < hi)


def owner_sum(values: torch.Tensor, in_slab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each entry of ``values`` from the rank whose slab owns it
    (``in_slab``, over the leading axes): the others' become -0.0, then one
    sum over the model group. Exact, whatever order the sum takes."""
    shape = in_slab.shape + (1,) * (values.ndim - in_slab.ndim)
    values = values.masked_fill(~in_slab.reshape(shape), -0.0)
    return mesh.all_reduce(values, MODEL_AXIS)


def gather_rows_sharded(table: torch.Tensor, idx: torch.Tensor, mesh: Optional[Mesh], num_rows: int) -> torch.Tensor:
    """``[M, C]`` f32 rows of the whole table for the global ids ``idx``
    (in range), ``table`` being this rank's slab: equal bit for bit to
    :func:`..ops.row_kernels.gather_rows` on the whole table. Without a mesh
    or with ``model == 1`` it is that call."""
    if mesh is None or mesh.model == 1:
        return gather_rows(table, idx)
    lo, hi = slab_range(mesh, num_rows)
    local, in_slab = to_local(idx, lo, hi)
    return owner_sum(gather_rows(table, local), in_slab, mesh)


def read_rows(table: torch.Tensor, ids: torch.Tensor, mesh: Optional[Mesh], num_rows: int) -> torch.Tensor:
    """f32 rows of the whole ``num_rows``-row table for in-range ``ids``,
    ``table`` being this rank's slab: serving's and evaluation's reads
    (``index_select`` on an unsharded table, :func:`gather_rows_sharded`
    on a row-sharded one)."""
    if mesh is None or mesh.model == 1:
        return table.index_select(0, ids).to(torch.float32)
    return gather_rows_sharded(table, ids, mesh, num_rows)


def cand_score_sharded(
    haug: torch.Tensor, table: torch.Tensor, cand: torch.Tensor, mesh: Optional[Mesh], num_rows: int
) -> torch.Tensor:
    """``[P, K]`` WARP candidate scores against the whole table,
    ``table`` being this rank's slab: each score from its row's owner (P3 or
    P4 on the slab), summed over the model group."""
    if mesh is None or mesh.model == 1:
        return cand_score(haug, table, cand)
    lo, hi = slab_range(mesh, num_rows)
    local, in_slab = to_local(cand, lo, hi)
    return owner_sum(cand_score(haug, table, local), in_slab, mesh)


def gather_slabs(table: torch.Tensor, mesh: Optional[Mesh], num_rows: int) -> torch.Tensor:
    """The whole ``[num_rows, ...]`` table on every rank of the model group,
    from each rank's slab ``table``."""
    if mesh is None or mesh.model == 1:
        return table
    n_loc = -(-num_rows // mesh.model)
    pad = table.new_zeros((n_loc,) + tuple(table.shape[1:]))
    pad[: table.shape[0]] = table
    return torch.cat(mesh.all_gather(pad, MODEL_AXIS))[:num_rows]


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "param_specs",
    "slab_range",
    "shard_model_params",
    "batch_slice",
    "batch_sharding",
    "to_local",
    "owner_sum",
    "gather_rows_sharded",
    "read_rows",
    "cand_score_sharded",
    "gather_slabs",
]
