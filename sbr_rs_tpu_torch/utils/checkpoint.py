"""Model checkpoints, in the JAX package's directory format. Counterpart of
:mod:`sbr_rs_tpu.utils.checkpoint`; each package loads the other's.

A checkpoint is a directory with

* ``state.msgpack`` — ``{"key": uint32[2], "params": tree, "torch": {...}}``
  in flax's msgpack format (:mod:`.msgpack_codec`, which writes the bytes
  flax writes for the same tree, streamed from the device, and reads them
  straight onto it). ``params`` is the model's parameter tree
  (``{"item_table": [N, D+1], "tower": ...}``), ``key`` the JAX PRNG key.
  ``torch`` holds what only this package has: the device type the model's
  generators ran on (``"device"``) and the states (uint8) of its training
  and dropout generators. The JAX package reads ``params`` and ``key`` and
  ignores ``torch``;
* ``config.json`` — the hyperparameters (``to_dict()``) and
  ``state_sha256``, the hash of ``state.msgpack``. It is written last, as
  the checkpoint's commit marker: a crash between the two writes leaves a
  config whose hash does not match the new state, which :func:`load_model`
  rejects.

Both files are written to a ``.tmp`` name and renamed into place.

**Generators.** Loaded on the device type it was saved from, a port
checkpoint restores both generators, so a continued ``fit`` draws what the
saved model's continued ``fit`` would, bit for bit. Otherwise (a JAX
checkpoint, or a port checkpoint moved between CPU and CUDA, whose
generators are of different kinds: the CPU's mt19937 and CUDA's Philox
states do not convert) both generators are seeded from the stored key,
``SeedSequence([key[0], key[1], 0])`` for training and ``[..., 1]`` for
dropout: loading the same checkpoint twice continues alike.

**Under a mesh** (:mod:`..parallel`) saving and loading are collective.
The format does not change: one file, one hash, readable by both packages,
with no trace of the mesh. The primary rank (rank 0) writes; a table
row-sharded over the model axis streams to it slab by slab, each other slab
sent by its owner in ``PIECE_BYTES`` pieces over the process group (through
pinned host buffers for gloo, device buffers for NCCL), so rank 0 never
holds a slab it does not own. A load at any world size has each rank read
its own slab's byte range of the table; rank 0 reads and hashes the whole
file, and a mismatch raises on every rank. The generator states saved are
rank 0's, which every rank shares.

**The key.** A model keeps the JAX key it was loaded with (``_jax_key``,
copied by ``clone``) and writes it back unchanged, so a JAX checkpoint
passed through this package returns to JAX with its key. A model built by
this package holds ``[0, seed mod 2**32]``, which is
``jax.random.PRNGKey(seed)``: a valid key, not the key the JAX package
would hold after the same draws (this package draws from torch
generators, never from it).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import slab_range
from . import msgpack_codec

STATE = "state.msgpack"
CONFIG = "config.json"


def fresh_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as it holds it: ``uint32 [0, seed mod 2**32]``."""
    return np.array([0, seed % 2**32], dtype=np.uint32)


def _key_seed(key: np.ndarray, stream: int) -> int:
    return int(np.random.SeedSequence([int(key[0]), int(key[1]), stream]).generate_state(1, np.uint64)[0])


class _ShardedTable(msgpack_codec.ByteSource):
    """The whole ``[N, C]`` table as rank 0 writes it: its own slab from its
    memory, every other slab received from the rank of its data row that
    owns it, a piece at a time (the owner runs :func:`_send_slab`)."""

    def __init__(self, mesh, slab: torch.Tensor, num_rows: int):
        super().__init__(slab.dtype, (num_rows,) + tuple(slab.shape[1:]))
        self.mesh = mesh
        self.local = slab.contiguous().reshape(-1).view(torch.uint8)
        row = len(self) // num_rows
        n_loc = -(-num_rows // mesh.model)
        self.bounds = [(j * n_loc * row, min((j + 1) * n_loc, num_rows) * row) for j in range(mesh.model)]
        self.piece = None  # (slab, first byte, received bytes) of the piece in hand

    def copy_range(self, dest: torch.Tensor, start: int, stop: int) -> None:
        at = 0
        while start < stop:
            j = next(j for j, (s0, s1) in enumerate(self.bounds) if s0 <= start < s1)
            s0, s1 = self.bounds[j]
            if j == self.mesh.m:
                k = min(stop, s1) - start
                dest[at : at + k].copy_(self.local[start - s0 : start - s0 + k])
            else:
                if self.piece is None or self.piece[0] != j or not (
                    self.piece[1] <= start < self.piece[1] + self.piece[2].numel()
                ):
                    first = s0 + (start - s0) // msgpack_codec.PIECE_BYTES * msgpack_codec.PIECE_BYTES
                    self.piece = (j, first, _recv_piece(self.mesh, j, min(s1 - first, msgpack_codec.PIECE_BYTES)))
                _, first, buf = self.piece
                k = min(stop, first + buf.numel()) - start
                dest[at : at + k].copy_(buf[start - first : start - first + k])
            start += k
            at += k


def _transfer_buffer(mesh, nbytes: int, device: torch.device) -> torch.Tensor:
    """A buffer the backend sends from and receives into: pinned host
    memory for gloo, the card's memory for NCCL."""
    if mesh.backend == "gloo":
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _recv_piece(mesh, slab: int, nbytes: int) -> torch.Tensor:
    """The next piece of slab ``slab`` from its owner in rank 0's data row.
    Pieces arrive in order, each once."""
    buf = _transfer_buffer(mesh, nbytes, torch.device("cuda"))
    dist.recv(buf, src=int(mesh.grid[mesh.d, slab]))
    return buf


def _send_slab(mesh, slab: torch.Tensor, dst: int) -> None:
    """Send this rank's slab to rank ``dst`` in ``PIECE_BYTES`` pieces, in
    order (:class:`_ShardedTable` receives them)."""
    flat = slab.contiguous().reshape(-1).view(torch.uint8)
    buf = _transfer_buffer(mesh, min(flat.numel(), msgpack_codec.PIECE_BYTES), flat.device)
    for a in range(0, flat.numel(), msgpack_codec.PIECE_BYTES):
        piece = flat[a : a + msgpack_codec.PIECE_BYTES]
        if mesh.backend == "nccl":
            dist.send(piece, dst=dst)
        else:
            buf[: piece.numel()].copy_(piece)
            dist.send(buf[: piece.numel()], dst=dst)


def save_model(model, path: str, timings: Optional[Dict[str, float]] = None) -> None:
    """Write ``model`` to the directory ``path`` (created if need be). With
    ``timings``, :func:`msgpack_codec.write` adds its seconds and bytes.
    Under a mesh every rank calls it; rank 0 writes (module docstring)."""
    mesh = model.hyper._mesh
    if mesh is not None and mesh.size > 1:
        if mesh.rank == 0:
            table = model._params["item_table"]
            if mesh.model > 1:
                table = _ShardedTable(mesh, table, model.hyper._num_items)
            _write(model, path, {"item_table": table, "tower": model._params["tower"]}, timings)
        elif mesh.model > 1 and mesh.d == int(np.argwhere(mesh.grid == 0)[0][0]):
            _send_slab(mesh, model._params["item_table"], dst=0)
        mesh.barrier()
        return
    _write(model, path, model._params, timings)


def _write(model, path: str, params, timings) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    state = {
        "key": model._jax_key,
        "params": params,
        "torch": {
            "device": model.device.type,
            "train_generator": model._train_generator.get_state(),
            "dropout_generator": model._dropout_generator.get_state(),
        },
    }
    tmp_state = p / (STATE + ".tmp")
    with open(tmp_state, "wb") as f:
        digest = msgpack_codec.write(f, state, timings)
    os.replace(tmp_state, p / STATE)

    config = model.hyper.to_dict()
    config["state_sha256"] = digest
    tmp_cfg = p / (CONFIG + ".tmp")
    tmp_cfg.write_text(json.dumps(config, indent=2))
    os.replace(tmp_cfg, p / CONFIG)


def _host(t: torch.Tensor) -> np.ndarray:
    """A small tensor's bytes on the host, as uint8 (any dtype, any device)."""
    return t.reshape(-1).view(torch.uint8).cpu().numpy()


def load_model(
    path: str,
    device: "torch.device | str" = "cuda",
    timings: Optional[Dict[str, float]] = None,
    mesh=None,
):
    """The model saved at ``path`` (by either package, under any mesh), on
    ``device``: the card unless the caller asks for ``"cpu"``. Without CUDA
    a ``cuda`` load raises before reading anything; nothing falls back to
    the CPU. Raises ``ValueError`` when ``state.msgpack`` does not match the
    hash in ``config.json`` or its table does not match the config's shape
    (files from different saves), or the model type is unknown. With
    ``mesh`` every rank of it calls this and keeps its own slab (module
    docstring). With ``timings``, :func:`msgpack_codec.read` adds its
    seconds."""
    from ..models import attention, ewma, gru, hstu, lstm, mla_moe

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot load a model onto {device}: this PyTorch has no usable CUDA device")
    p = Path(path)
    config = json.loads((p / CONFIG).read_text())
    config.pop("np_rng_state", None)  # a legacy field of the JAX package
    want_hash = config.pop("state_sha256", None)
    families = {
        "lstm": (lstm, lstm.ImplicitLSTMModel),
        "ewma": (ewma, ewma.ImplicitEWMAModel),
        "attention": (attention, attention.ImplicitAttentionModel),
        "gru": (gru, gru.ImplicitGRUModel),
        "hstu": (hstu, hstu.ImplicitHSTUModel),
        "mla_moe": (mla_moe, mla_moe.ImplicitMLAMoEModel),
    }
    model_type = config["model_type"]
    if model_type not in families:
        raise ValueError(f"Unknown model_type: {model_type}")
    want = (config["num_items"], config["item_embedding_dim"] + 1)
    lo, hi = slab_range(mesh, want[0])
    select = {("params", "item_table"): (lo, hi, want[0])} if (lo, hi) != (0, want[0]) else None
    primary = mesh is None or mesh.size == 1 or mesh.rank == 0
    state, digest = msgpack_codec.read(p / STATE, device, timings, select=select, verify=primary)
    ok = torch.tensor([primary and (want_hash is None or digest == want_hash)], dtype=torch.int32, device=device)
    if mesh is not None:
        mesh.broadcast(ok, src=0)
    if not bool(ok):
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: state.msgpack does "
            "not match the hash recorded in config.json — the directory "
            "holds files from different saves."
        )
    table = state["params"]["item_table"]
    if tuple(table.shape) != (hi - lo, want[1]):
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: item_table shape "
            f"{tuple(table.shape)} but config expects {want} — the "
            "checkpoint directory holds files from different saves."
        )

    family, model_cls = families[model_type]
    # Built around the file's table (this rank's slab): no table is drawn.
    model = model_cls(family.Hyperparameters.from_dict(config).mesh(mesh), device, item_table=table)
    model._install_params(model._params["item_table"], state["params"]["tower"])
    model._jax_key = _host(state["key"]).view(np.uint32).copy()
    saved = state.get("torch")
    if saved is not None and saved["device"] == device.type:
        model._train_generator.set_state(torch.from_numpy(_host(saved["train_generator"])))
        model._dropout_generator.set_state(torch.from_numpy(_host(saved["dropout_generator"])))
    else:
        model._train_generator.manual_seed(_key_seed(model._jax_key, 0))
        model._dropout_generator.manual_seed(_key_seed(model._jax_key, 1))
    return model
