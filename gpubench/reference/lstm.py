"""The LSTM (sbr-rs ``src/models/lstm.rs``; Hochreiter and Schmidhuber):
gates ``[i, f, g, o]`` in ``w_x``, ``w_h`` ``[D, 4D]`` and ``b [4D]``, or
``[i, g, o]`` with ``f = 1 - i`` (Coupled); ``h`` and ``c`` start at zero."""

from __future__ import annotations

from typing import Dict

import torch


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor):
    """Hidden states ``[B, T, D]`` of ``x [B, T, D]``."""
    coupled = cfg["lstm_variant"] == "coupled"
    b, t, d = x.shape
    h = x.new_zeros((b, d))
    c = x.new_zeros((b, d))
    out = []
    for s in range(t):
        z = x[:, s] @ p["w_x"] + p["b"] + h @ p["w_h"]
        if coupled:
            i, g, o = z.split(d, dim=1)
            i = torch.sigmoid(i)
            c = (1 - i) * c + i * torch.tanh(g)
        else:
            i, f, g, o = z.split(d, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)
