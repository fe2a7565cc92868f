"""Parameters between the JAX package and this one, as numpy arrays.

The tree is the one ``sbr_rs_tpu/utils/checkpoint.py`` saves under
``"params"``: ``{"item_table": [N, D+1], "tower": ...}``, the tower a tree
of nested dicts and lists as the family builds it (``{"w_x", "w_h", "b"}``
for the LSTM and GRU, ``{"alpha"}`` for EWMA, ``{"pos", "layers": [...],
"ln_f"}`` for attention). Checkpoints need none of this: each package
reads the other's directory directly (:mod:`.checkpoint`, on the codec of
:mod:`.msgpack_codec`, which needs neither ``msgpack`` nor ``ml_dtypes``).
Here the arrays are handed over in memory, as numpy's ``bfloat16`` of
``ml_dtypes`` where a table is bf16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .tree import map_leaves


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, for the numpy hand-off of bf16 tables

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_numpy(tree: Dict, device: "torch.device | str") -> Dict:
    """The JAX package's parameter tree (numpy arrays; dicts and lists) as
    this package's parameters (tensors on ``device``, dtypes kept)."""
    device = torch.device(device)
    return map_leaves(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(model_or_params) -> Dict:
    """A model's parameters (or a parameter tree) as the JAX package's tree
    of numpy arrays, lists kept as lists."""
    return map_leaves(_to_numpy, getattr(model_or_params, "_params", model_or_params))
