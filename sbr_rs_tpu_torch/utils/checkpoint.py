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

from . import msgpack_codec

STATE = "state.msgpack"
CONFIG = "config.json"


def fresh_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as it holds it: ``uint32 [0, seed mod 2**32]``."""
    return np.array([0, seed % 2**32], dtype=np.uint32)


def _key_seed(key: np.ndarray, stream: int) -> int:
    return int(np.random.SeedSequence([int(key[0]), int(key[1]), stream]).generate_state(1, np.uint64)[0])


def save_model(model, path: str, timings: Optional[Dict[str, float]] = None) -> None:
    """Write ``model`` to the directory ``path`` (created if need be). With
    ``timings``, :func:`msgpack_codec.write` adds its seconds and bytes."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    state = {
        "key": model._jax_key,
        "params": model._params,
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


def load_model(path: str, device: "torch.device | str" = "cuda", timings: Optional[Dict[str, float]] = None):
    """The model saved at ``path`` (by either package), on ``device``: the
    card unless the caller asks for ``"cpu"``. Without CUDA a ``cuda`` load
    raises before reading anything; nothing falls back to the CPU. Raises
    ``ValueError`` when ``state.msgpack`` does not match the hash in
    ``config.json`` or its table does not match the config's shape (files
    from different saves), or the model type is unknown. With ``timings``,
    :func:`msgpack_codec.read` adds its seconds."""
    from ..models import attention, ewma, gru, lstm

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"cannot load a model onto {device}: this PyTorch has no usable CUDA device")
    p = Path(path)
    config = json.loads((p / CONFIG).read_text())
    config.pop("np_rng_state", None)  # a legacy field of the JAX package
    want_hash = config.pop("state_sha256", None)
    state, digest = msgpack_codec.read(p / STATE, device, timings)
    if want_hash is not None and digest != want_hash:
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: state.msgpack does "
            "not match the hash recorded in config.json — the directory "
            "holds files from different saves."
        )
    families = {"lstm": lstm, "ewma": ewma, "attention": attention, "gru": gru}
    model_type = config["model_type"]
    if model_type not in families:
        raise ValueError(f"Unknown model_type: {model_type}")
    table = state["params"]["item_table"]
    want = (config["num_items"], config["item_embedding_dim"] + 1)
    if tuple(table.shape) != want:
        raise ValueError(
            f"Checkpoint state/config mismatch at {path}: item_table shape "
            f"{tuple(table.shape)} but config expects {want} — the "
            "checkpoint directory holds files from different saves."
        )

    model = families[model_type].Hyperparameters.from_dict(config).build(device)
    model.load_params(state["params"])
    model._jax_key = _host(state["key"]).view(np.uint32).copy()
    saved = state.get("torch")
    if saved is not None and saved["device"] == device.type:
        model._train_generator.set_state(torch.from_numpy(_host(saved["train_generator"])))
        model._dropout_generator.set_state(torch.from_numpy(_host(saved["dropout_generator"])))
    else:
        model._train_generator.manual_seed(_key_seed(model._jax_key, 0))
        model._dropout_generator.manual_seed(_key_seed(model._jax_key, 1))
    return model
