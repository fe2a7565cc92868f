"""The batched training engine: parameter initialisation of the fused item
table, the optimizer state and one training step. Counterpart of
:mod:`sbr_rs_tpu.models.engine`.

One step over a ``[B, T]`` batch of windows (:class:`..data.StreamWindows`
layout), as the JAX step does it:

1. negative candidates, K=5 for WARP, K=1 otherwise, drawn uniformly by
   the caller (``src/models/sequence_model.rs:47-68, 125-138``);
2. ONE gather of the ``[B, T + 1]`` stream rows serves inputs and positives
   (:func:`..ops.row_kernels.gather_rows`, as are all the step's row
   gathers); the loss is differentiated with respect to the gathered row
   COPIES (and the tower), never the table, so the backward costs O(batch);
3. the tower runs once; WARP scores the candidates against the detached
   hidden state (:func:`..ops.row_kernels.cand_score`: the ``[B, T, K, C]``
   candidate rows are never built) and keeps the first margin violator,
   else the last draw; only the selected negative's rows join the
   differentiated set;
4. scores dot a bias-augmented hidden state against whole fused rows; the
   pairwise loss is masked and summed (``src/models/lstm.rs:322-328``);
5. the table update, one of two:
   * dense (small catalogs): :func:`..ops.optimizers.dedupe_and_sum` sums
     each touched row's gradients in a fixed order (so two runs give the
     same bits), one scatter of the unique rows
     (:func:`..ops.row_kernels.scatter_add_rows_`) lays them out, and the
     whole table takes :func:`..ops.optimizers.dense_row_update` under their
     touched and bias-touched flags;
   * sparse (``sparse_updates=True``): :func:`..ops.optimizers.dedupe_and_sum`
     sums each touched row's gradients, and
     :func:`..ops.optimizers.sparse_update` updates those rows alone;
   the tower takes :func:`..ops.optimizers.dense_update`.

PyTorch runs eagerly: there is no compiled program, and the step returns
its loss as a device tensor so the host never waits on it.

Under a mesh (:mod:`..parallel`) the step is collective: every rank of the
mesh calls it with its own share of the batch (the ``data`` axis) and its
own slab of the table (the ``model`` axis, where XLA would partition the
JAX step):

* the row gathers and WARP's candidate scores read the whole table through
  :func:`..parallel.sharding.gather_rows_sharded` and
  :func:`..parallel.sharding.cand_score_sharded` (P1, P3/P4 on the slab, a
  sum over the model group), equal bit for bit to the unsharded ones;
* the tower's gradients are summed over the data group, so every replica
  applies the same update;
* the touched rows' gradients and flags are gathered over the data group,
  every rank's stream part in data order and then every rank's negative
  part: the one-rank step's ``flat_idx`` order, so :func:`..ops.optimizers.
  dedupe_and_sum` sums each row's run as one rank would. Each rank then
  updates the rows of its own slab (local ids; the others invalid).

After each step the replicas along the data axis hold the same bits,
because every collective returns the same bits on every rank. The loss
stays the rank's own share; ``fit`` sums the shares over the data group.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import optimizers as opt_ops
from ..ops.losses import pairwise_loss
from ..ops.row_kernels import scatter_add_rows_
from ..ops.sampling import WARP_CANDIDATES, warp_select_onehot
from ..parallel.mesh import DATA_AXIS
from ..parallel.sharding import batch_slice, cand_score_sharded, gather_rows_sharded, slab_range, to_local
from ..utils.tree import flatten, unflatten
from . import Loss, Optimizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """What the step closes over (the JAX package's fields and defaults).
    ``lr_schedule``: ``"constant"`` (the reference's), ``"linear"`` (decay
    to 0), ``"cosine"`` or ``"warmup_cosine"`` (linear warm-up over the
    first 10 % of steps). ``sparse_updates``: the touched-rows table
    update (sort + segment sums, traffic O(batch)) instead of the dense
    full-table one."""

    num_items: int
    loss: Loss
    optimizer: Optimizer
    learning_rate: float
    l2_penalty: float
    lr_schedule: str = "constant"
    sparse_updates: bool = True


def table_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``table_dtype`` hyperparameter."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"table_dtype must be one of {sorted(_DTYPES)}, got {name!r}") from None


# Rows of the item table drawn by one ``normal_`` call: the table is drawn
# chunk by chunk, so a rank can keep its slab and hold no more than one
# chunk of the rest.
INIT_CHUNK_ROWS = 1 << 20


def init_embedding_params(
    generator: torch.Generator,
    num_items: int,
    dim: int,
    device: torch.device,
    dtype: str = "float32",
    init_scale: float = 1.0,
    rows: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """The fused item table ``[num_items, dim + 1]`` in the storage dtype:
    embedding columns ``N(0, 1) * init_scale / dim`` (reference
    ``src/models/lstm.rs:22-25``, as the JAX package draws them) and the
    bias as the last column, zero (``src/models/lstm.rs:181``). Drawn in
    place on ``device`` from ``generator``, ``INIT_CHUNK_ROWS`` rows at a
    time. ``rows = (lo, hi)`` keeps those rows alone (a rank's slab): the
    chunks are drawn all the same, the others into a scratch chunk of the
    same layout, so the rows kept are the whole draw's bit for bit and the
    generator ends where the whole draw leaves it."""
    lo, hi = (0, num_items) if rows is None else rows
    table = torch.empty((hi - lo, dim + 1), dtype=table_dtype(dtype), device=device)
    scratch = None
    for a in range(0, num_items, INIT_CHUNK_ROWS):
        b = min(a + INIT_CHUNK_ROWS, num_items)
        if lo <= a and b <= hi:
            table[a - lo : b - lo, :dim].normal_(generator=generator)
            continue
        if scratch is None:
            scratch = torch.empty((min(INIT_CHUNK_ROWS, num_items), dim + 1), dtype=table.dtype, device=device)
        scratch[: b - a, :dim].normal_(generator=generator)
        if max(a, lo) < min(b, hi):
            table[max(a, lo) - lo : min(b, hi) - lo] = scratch[max(a, lo) - a : min(b, hi) - a]
    table[:, :dim].mul_(init_scale / dim)
    table[:, dim].zero_()
    return {"item_table": table}


def table_embeddings(params: Dict) -> torch.Tensor:
    """Embedding-columns view of the fused table."""
    return params["item_table"][:, :-1]


def table_biases(params: Dict) -> torch.Tensor:
    """Bias-column view of the fused table."""
    return params["item_table"][:, -1]


def init_opt_state(kind: Optimizer, params: Dict) -> Dict:
    """Fresh optimizer state: a host step count and zero state per tensor,
    the tower's keyed by each leaf's path (:func:`..utils.tree.flatten`)."""
    return {
        "step": 0,
        "item_table": opt_ops.init_state(kind, params["item_table"]),
        "tower": {path: opt_ops.init_state(kind, p) for path, p in flatten(params["tower"])},
    }


def scheduled_lr(lr: float, schedule: str, step: int, total_steps: int) -> float:
    """The learning rate of step ``step`` of ``total_steps`` (0: constant)."""
    if not total_steps or schedule == "constant":
        return lr
    if schedule == "linear":
        return lr * (1.0 - step / total_steps)
    if schedule == "cosine":
        return lr * 0.5 * (1.0 + math.cos(math.pi * step / total_steps))
    if schedule == "warmup_cosine":
        warm = max(1.0, 0.1 * total_steps)
        if step < warm:
            return lr * (step + 1.0) / warm
        return lr * 0.5 * (1.0 + math.cos(math.pi * (step - warm) / max(1.0, total_steps - warm)))
    raise ValueError(f"unknown lr schedule: {schedule!r}")


def make_train_step(
    config: EngineConfig,
    tower_apply: Callable[..., torch.Tensor],
    total_steps: int = 0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    shares: int = 1,
) -> Callable:
    """Build the training step (over ``mesh``'s ranks when given: module
    docstring). ``shares > 1`` (no mesh) runs each batch as that many
    contiguous shares in this process and sums them as a ``(data=shares)``
    mesh's ranks do: the collective-free reference of the data axis (with
    two shares, bit-equal to a ``(2, m)`` mesh's step on the same draws).

    ``tower_apply(tower_params, x [B, T, D], starts=None) -> hidden [B, T, D]``
    must be differentiable with respect to ``x`` and the tower parameters,
    a tree of tensors (nested dicts and lists). A tower whose signature
    takes ``generator`` (attention's dropout) is handed ``generator``, the
    model's own dropout generator, and draws from nothing else; the other
    towers are called without it. So the candidates and permutations the
    caller draws never depend on the tower, as in the JAX package, whose
    step folds the tower's key out of the step key.

    Returns ``train_step(params, opt_state, batch, candidates, lr=None,
    l2=None) -> (params, opt_state, loss_sum)``. ``batch`` holds an int
    ``stream [B, T + 1]`` (input at position t is ``stream[:, t]``, its
    target ``stream[:, t + 1]``), a float ``mask [B, T]`` and, for packed
    batches, ``starts [B, T]``, all on the parameters' device.
    ``candidates [B, T, K]`` (int, K = 5 for WARP, else 1) are the uniform
    negative draws; the caller makes them (the fit from its training
    generator). ``loss_sum`` is the masked pre-update loss sum as a 0-d
    device tensor.

    The step updates the item table, the tower weights and their optimizer
    state IN PLACE and returns the same tensors; ``opt_state["step"]``
    advances by one.
    """
    is_warp = config.loss == Loss.WARP
    k_cand = WARP_CANDIDATES if is_warp else 1
    num_items = config.num_items
    kind = config.optimizer
    tower_params = inspect.signature(tower_apply).parameters
    tower_kwargs = {}
    if "generator" in tower_params:
        tower_kwargs["generator"] = generator
    split = mesh is not None and mesh.data > 1
    sharded = mesh is not None and mesh.model > 1
    if sharded and not config.sparse_updates:
        raise ValueError("a row-sharded table takes the sparse update")
    if shares > 1 and mesh is not None:
        raise ValueError("shares emulate a data axis in one process: give no mesh")

    def share_grads(params, batch, candidates, dropout_rows):
        """The loss sum, the tower's gradients and the touched rows
        ``(d_rows, flat_idx, occ_valid, bias_occ)`` of one share of a
        batch (stream slots first, then the negatives)."""
        stream = batch["stream"].long()
        mask = batch["mask"]
        starts = batch.get("starts")
        b, t = stream.shape[0], stream.shape[1] - 1
        table = params["item_table"]
        c_param = table.shape[1]
        dev = table.device
        if candidates.shape != (b, t, k_cand):
            raise ValueError(
                f"candidates have shape {tuple(candidates.shape)}, expected {(b, t, k_cand)}"
            )
        candidates = candidates.long()

        def gather(idx: torch.Tensor) -> torch.Tensor:
            # f32 copies of the rows, whatever the storage dtype.
            rows = gather_rows_sharded(table, idx.reshape(-1), mesh, num_items)
            return rows.reshape(idx.shape + (c_param,))

        rows_s = gather(stream).requires_grad_()
        tower_pairs = flatten(params["tower"])
        paths = [path for path, _ in tower_pairs]
        tower_leaves = [p.detach().requires_grad_() for _, p in tower_pairs]
        in_emb, pos_rows = rows_s[:, :t, :-1], rows_s[:, 1:, :]
        kwargs = dict(tower_kwargs)
        if dropout_rows is not None and "dropout_rows" in tower_params:
            kwargs["dropout_rows"] = dropout_rows
        hidden = tower_apply(unflatten(paths, tower_leaves), in_emb, starts=starts, **kwargs)
        haug = torch.cat([hidden, hidden.new_ones((b, t, 1))], dim=-1)
        pos_score = (haug * pos_rows).sum(-1)
        if is_warp:
            with torch.no_grad():
                cand_scores = cand_score_sharded(
                    haug.detach().reshape(b * t, c_param), table, candidates.reshape(b * t, k_cand),
                    mesh, num_items,
                ).reshape(b, t, k_cand)
                onehot = warp_select_onehot(pos_score.detach(), cand_scores)
                negatives = (candidates * onehot.long()).sum(-1)
        else:
            negatives = candidates[:, :, 0]
        neg_rows = gather(negatives).requires_grad_()
        neg_score = (haug * neg_rows).sum(-1)
        loss_sum = (pairwise_loss(config.loss, pos_score, neg_score) * mask).sum()

        leaves = [rows_s, neg_rows, *tower_leaves]
        grads = torch.autograd.grad(loss_sum, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]
        d_rows = torch.cat([grads[0].reshape(-1, c_param), grads[1].reshape(-1, c_param)])

        # Stream-slot occurrence flags: slot p is an input occurrence iff
        # position p is supervised, a target occurrence iff position p-1 is.
        mask_b = mask > 0
        zero_col = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        in_occ = torch.cat([mask_b, zero_col], dim=1).reshape(-1)
        tg_occ = torch.cat([zero_col, mask_b], dim=1).reshape(-1)
        mask_flat = mask_b.reshape(-1)
        occ_valid = torch.cat([in_occ | tg_occ, mask_flat])
        # Input occurrences touch only the embedding columns: the bias of a
        # row touched only as an input gets no L2, state or step.
        bias_occ = torch.cat([tg_occ, mask_flat])
        flat_idx = torch.cat([stream.reshape(-1), negatives.reshape(-1)])
        return loss_sum.detach(), grads[2:], (d_rows, flat_idx, occ_valid, bias_occ)

    def train_step(
        params: Dict,
        opt_state: Dict,
        batch: Dict[str, torch.Tensor],
        candidates: torch.Tensor,
        lr: Optional[float] = None,
        l2: Optional[float] = None,
    ):
        lr = config.learning_rate if lr is None else lr
        l2 = config.l2_penalty if l2 is None else l2
        b, t = batch["stream"].shape[0], batch["stream"].shape[1] - 1
        table = params["item_table"]
        c_param = table.shape[1]
        dev = table.device
        if shares > 1:
            loss_sum, tower_grads, rows = _sum_shares(share_grads, shares, params, batch, candidates, generator)
        else:
            dropout_rows = (b * mesh.data, batch_slice(mesh, b * mesh.data)) if split else None
            loss_sum, tower_grads, rows = share_grads(params, batch, candidates, dropout_rows)
            if split:
                tower_grads = _sum_over_data(mesh, tower_grads)
                rows = _gather_over_data(mesh, b * (t + 1), *rows)
        d_rows, flat_idx, occ_valid, bias_occ = rows

        step = opt_state["step"]
        lr_t = scheduled_lr(lr, config.lr_schedule, step, total_steps)
        if config.sparse_updates:
            dd, summed, bias_valid = opt_ops.dedupe_and_sum(
                flat_idx, occ_valid, d_rows, bias_occ, num_items
            )
            if sharded:
                dd = _slab_rows(dd, *slab_range(mesh, num_items))
            opt_ops.sparse_update(
                kind, lr_t, l2, table, opt_state["item_table"], dd, summed, step,
                bias_valid=bias_valid,
            )
        else:
            # The row gradients summed in a fixed order (the sparse path's
            # sorted run sums: a float scatter-add on the card sums with
            # atomics in a run-dependent order), then one scatter of each
            # touched row's sum by the row kernel (the sentinel slots drop)
            # and its touched and bias-touched flags (repeated ids only at
            # the sentinel, which every non-live slot writes False to).
            dd, summed, bias_valid = opt_ops.dedupe_and_sum(
                flat_idx, occ_valid, d_rows, bias_occ, num_items
            )
            grad = scatter_add_rows_(summed.new_zeros((num_items, c_param)), dd.row_ids, summed)
            touched = torch.zeros((num_items + 1,), dtype=torch.bool, device=dev)
            bias_touched = torch.zeros_like(touched)
            touched[dd.row_ids] = dd.valid
            bias_touched[dd.row_ids] = dd.valid & bias_valid
            opt_ops.dense_row_update(
                kind, lr_t, l2, table, opt_state["item_table"], grad,
                touched[:num_items], step, bias_touched=bias_touched[:num_items],
            )
        for (path, p), d_p in zip(flatten(params["tower"]), tower_grads):
            opt_ops.dense_update(kind, lr_t, l2, p, opt_state["tower"][path], d_p, step)
        opt_state["step"] = step + 1
        return params, opt_state, loss_sum

    return train_step


def _sum_over_data(mesh, grads):
    """The tower's gradients summed over the data group, in one collective."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce(flat, DATA_AXIS)
    out, at = [], 0
    for g in grads:
        out.append(flat[at : at + g.numel()].reshape(g.shape))
        at += g.numel()
    return out


def _in_one_rank_order(parts, split_at):
    """The shares' first ``split_at`` entries (their stream slots) in share
    order, then the rest of each (their negatives): the one-rank step's
    ``flat_idx`` order."""
    return torch.cat([p[:split_at] for p in parts] + [p[split_at:] for p in parts])


def _gather_over_data(mesh, split_at, d_rows, flat_idx, occ_valid, bias_occ):
    """The data group's touched rows in the one-rank step's order. The ids
    and the two flags travel as one int64 ``id * 4 + occ * 2 + bias``."""
    meta = flat_idx * 4 + occ_valid.long() * 2 + bias_occ.long()
    d_rows = _in_one_rank_order(mesh.all_gather(d_rows, DATA_AXIS), split_at)
    meta = _in_one_rank_order(mesh.all_gather(meta, DATA_AXIS), split_at)
    return d_rows, meta >> 2, (meta & 2) > 0, (meta & 1) > 0


def _sum_shares(share_grads, shares, params, batch, candidates, generator):
    """One process's counterpart of a ``(data=shares)`` mesh's step: the
    batch's ``shares`` contiguous shares one after the other, their losses
    and tower gradients summed in share order, their rows in the one-rank
    order. Each share draws attention's dropout masks from the generator's
    state at the step's start, as each rank does. With two shares every
    sum is the data group's single ``a + b``, so the step is the mesh's bit
    for bit."""
    b, t = batch["stream"].shape[0], batch["stream"].shape[1] - 1
    if b % shares:
        raise ValueError(f"a batch of {b} rows does not split into {shares} shares")
    n = b // shares
    state = None if generator is None else generator.get_state()
    parts = []
    for s in range(shares):
        rows = slice(s * n, (s + 1) * n)
        if state is not None:
            generator.set_state(state)
        share = {k: v[rows] for k, v in batch.items()}
        parts.append(share_grads(params, share, candidates[rows], (b, rows)))
    loss_sum, tower_grads = parts[0][0], parts[0][1]
    for loss, grads, _ in parts[1:]:
        loss_sum = loss_sum + loss
        tower_grads = [a + g for a, g in zip(tower_grads, grads)]
    rows = tuple(_in_one_rank_order([p[2][i] for p in parts], n * (t + 1)) for i in range(4))
    return loss_sum, tower_grads, rows


def _slab_rows(dd, lo: int, hi: int):
    """``dd`` with its rows in slab-local ids, the rows of other slabs
    marked invalid (id ``hi - lo``: the scatters drop it)."""
    local, in_slab = to_local(dd.row_ids, lo, hi)
    valid = dd.valid & in_slab
    return opt_ops.DedupedRows(dd.order, dd.seg_id, torch.where(valid, local, hi - lo), valid)
