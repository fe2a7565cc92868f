"""Parameters between the JAX package and this one, as numpy arrays.

The tree is the one ``sbr_rs_tpu/utils/checkpoint.py`` saves under
``"params"``: ``{"item_table": [N, D+1], "tower": {"w_x", "w_h", "b"}}``.
Reading ``state.msgpack`` itself needs flax (and so jax) and is not done
here: hand over the arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; needed only for bf16 tables

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_numpy(tree: Dict, device: "torch.device | str") -> Dict:
    """The JAX package's parameter tree (numpy arrays) as this package's
    parameters (tensors on ``device``, dtypes kept)."""
    device = torch.device(device)
    return {
        "item_table": _to_tensor(tree["item_table"], device),
        "tower": {name: _to_tensor(v, device) for name, v in tree["tower"].items()},
    }


def params_to_numpy(model_or_params) -> Dict:
    """A model's parameters (or a parameter dict) as the JAX package's tree
    of numpy arrays."""
    params = getattr(model_or_params, "_params", model_or_params)
    return {
        "item_table": _to_numpy(params["item_table"]),
        "tower": {name: _to_numpy(v) for name, v in params["tower"].items()},
    }
