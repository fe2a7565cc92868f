"""Multi-process start-up and the mesh over the whole world. Counterpart of
:mod:`sbr_rs_tpu.parallel.distributed`.

One process runs each rank. A launcher (``torchrun``, or any that sets the
same variables) starts them with ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; each process calls
:func:`initialize` once, before it builds a model, then builds its mesh
(:func:`global_mesh` or :func:`.mesh.make_mesh`)::

    from sbr_rs_tpu_torch import parallel
    parallel.initialize()                  # NCCL, one card per rank
    mesh = parallel.global_mesh(model=2)   # (world / 2, 2)
    model = lstm.Hyperparameters(n, 64).mesh(mesh)....build()

Single-process use needs none of this.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, world


def initialize(
    backend: str = "nccl",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group (a no-op when nothing asks for one).

    Arguments not given are read from torch's own variables: ``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` (``init_method="env://"``).
    With none of them given or set, the process stays single-rank. The
    backend is the caller's: ``"nccl"`` (the default; one card per rank, the
    card ``LOCAL_RANK``, else ``rank`` modulo the cards present) raises when
    this PyTorch has no NCCL or no card; ``"gloo"`` runs on the host, and its
    collectives take CUDA tensors through host copies (:mod:`.mesh`).
    ``timeout_s`` bounds each collective, so a lost rank raises rather than
    hangs. A bad address or a mismatched world size raises at start-up."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size is None and rank is None:
        return  # single process
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if backend == "nccl":
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError("backend='nccl' needs a CUDA card and a PyTorch built with NCCL")
        local = int(env.get("LOCAL_RANK", (rank or 0) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def global_mesh(model: int = 1) -> Mesh:
    """A ``(world / model, model)`` mesh over every rank; raises
    ``ValueError`` when ``model`` does not divide the world size."""
    size, _ = world()
    if model < 1 or size % model:
        raise ValueError(f"model={model} does not divide {size} ranks")
    return make_mesh(data=size // model, model=model)


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs (rank 0, or the one
    process)."""
    return world()[1] == 0


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
