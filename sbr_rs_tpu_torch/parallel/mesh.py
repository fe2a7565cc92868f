"""The ``(data, model)`` mesh of ranks and its collectives. Counterpart of
:mod:`sbr_rs_tpu.parallel.mesh`.

The JAX package runs one program over a ``jax.sharding.Mesh`` of devices,
and XLA inserts the collectives. Here each rank is a process of a
``torch.distributed`` process group, and the model calls the collectives
itself, over one of the mesh's two axes:

* ``data`` — the batch is split over it; the ranks of one data group hold
  the same model index (the same slab of the item table) and sum their
  gradients;
* ``model`` — the item table is row-sharded over it; the ranks of one model
  group hold the same data index (the same share of the batch) and combine
  their slabs' rows.

The layout is the JAX one, ``ranks.reshape(data, model)``: rank ``r`` sits at
``(r // model, r % model)``. A mesh spans the whole process group (or, with
none initialised, the one process).

**Gloo and CUDA tensors.** gloo's ``all_reduce``, ``all_gather`` and
``broadcast`` take CUDA tensors (checked on an H100 with torch 2.11: gloo
copies them through the host itself), and they are the only collectives
the mesh calls. gloo's point-to-point ``send`` does not (a CUDA tensor
there ends the process), so the checkpoint's slab transfer sends pinned host
pieces under gloo (:mod:`..utils.checkpoint`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(n: int, data: Optional[int] = None, model: Optional[int] = None) -> Tuple[int, int]:
    """``(data, model)`` over ``n`` ranks by the JAX package's rules: with
    one axis given, the other takes the remaining ranks; with neither, all
    go to ``data``. Raises ``ValueError`` when an axis does not divide
    ``n`` or the product is not ``n``."""
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if model < 1 or n % model:
            raise ValueError(f"model={model} does not divide {n} ranks")
        data = n // model
    elif model is None:
        if data < 1 or n % data:
            raise ValueError(f"data={data} does not divide {n} ranks")
        model = n // data
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return int(data), int(model)


def world() -> Tuple[int, int]:
    """``(world size, rank)`` of the default process group; ``(1, 0)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A ``(data, model)`` grid of the process group's ranks: the sizes
    (``data``, ``model``), this rank's coordinates (``d``, ``m``) and the
    process groups of its data axis (the ranks with its model index) and
    its model axis (the ranks with its data index), ``None`` for an axis of
    size 1. ``stats`` counts the collectives this rank ran: calls, payload
    bytes and host seconds inside them."""

    def __init__(self, data: int, model: int, ranks: Sequence[int]):
        self.data, self.model = int(data), int(model)
        self.grid = np.asarray(ranks, dtype=np.int64).reshape(self.data, self.model)
        size, self.rank = world()
        self.backend = dist.get_backend() if size > 1 else None  # "gloo" or "nccl"
        (d,), (m,) = np.nonzero(self.grid == self.rank)
        self.d, self.m = int(d), int(m)
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {DATA_AXIS: None, MODEL_AXIS: None}
        # new_group is itself collective: every rank creates every group, in
        # the same order.
        if self.data > 1:
            for col in range(self.model):
                g = dist.new_group(self.grid[:, col].tolist())
                if col == self.m:
                    self._groups[DATA_AXIS] = g
        if self.model > 1:
            for row in range(self.data):
                g = dist.new_group(self.grid[row].tolist())
                if row == self.d:
                    self._groups[MODEL_AXIS] = g
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self.device: Optional[torch.device] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model}, rank {self.rank} at ({self.d}, {self.m}))"

    def axis_size(self, axis: Optional[str]) -> int:
        """Ranks along ``axis`` (``None``: the whole mesh)."""
        return self.size if axis is None else self.shape[axis]

    def _group(self, axis: Optional[str]):
        return None if axis is None else self._groups[axis]

    def _count(self, nbytes: int, t0: float) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += int(nbytes)
        self.stats["seconds"] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (``None``: every rank); every
        rank of the group gets the same bits. Returns ``t``."""
        if self.axis_size(axis) == 1:
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self._group(axis))
        self._count(t.numel() * t.element_size(), t0)
        return t

    def all_gather(self, t: torch.Tensor, axis: Optional[str]) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on each) along ``axis``, in the
        axis's order."""
        if self.axis_size(axis) == 1:
            return [t]
        t0 = time.perf_counter()
        n = self.axis_size(axis)
        src = t.contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self._group(axis))
        self._count(n * src.numel() * src.element_size(), t0)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of the global rank ``src`` on every rank, in place."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        dist.broadcast(t, src)
        self._count(t.numel() * t.element_size(), t0)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(
    data: Optional[int] = None,
    model: Optional[int] = None,
    devices: Optional[Sequence["torch.device | str"]] = None,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A ``(data, model)`` mesh over the process group's ranks (default: all,
    in order; ``ranks`` may order them otherwise), by the rules of
    :func:`mesh_shape`. Every rank calls it, with the same arguments (the
    axis groups are made collectively). Without an initialised process group
    the world is this one process. Raises ``ValueError`` when the mesh does
    not cover the process group's ranks exactly once.

    ``devices``, as in the JAX package, names the mesh's devices in the
    mesh's order: one a rank, ``devices[i]`` that of rank ``ranks[i]``.
    This rank's device becomes ``Mesh.device``, and a card becomes the
    process's current one, the card a ``build()`` without a device takes.
    Raises ``ValueError`` when there is not one device a rank, or a card
    named is not present."""
    size, rank = world()
    ranks = list(range(size)) if ranks is None else [int(r) for r in ranks]
    if sorted(ranks) != list(range(size)):
        raise ValueError(f"a mesh spans the process group's {size} ranks exactly once, got ranks {ranks}")
    data, model = mesh_shape(len(ranks), data, model)
    device = None
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != len(ranks):
            raise ValueError(f"{len(devices)} devices for a mesh of {len(ranks)} ranks: one a rank")
        device = devices[ranks.index(rank)]
        if device.type == "cuda":
            if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"{device} is not present")
            if device.index is not None:
                torch.cuda.set_device(device.index)
        elif device.type != "cpu":
            raise ValueError(f"a rank runs on cuda or cpu, not {device}")
    mesh = Mesh(data, model, ranks)
    mesh.device = device
    return mesh
