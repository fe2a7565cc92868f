"""SASRec (Kang and McAuley 2018, section III): learned positions, pre-LN
blocks of one causal attention and a point-wise ReLU FFN, each branch added
back, a final layer norm (eps 1e-6, the port's)."""

from __future__ import annotations

from typing import Dict

import torch


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-6)


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor):
    """Outputs ``[B, T, D]`` of ``x [B, T, D]``."""
    layers, heads = int(cfg["num_layers"]), int(cfg["num_heads"])
    b, t, d = x.shape
    idx = torch.arange(t, device=x.device)
    allowed = idx[:, None] >= idx[None, :]
    h = x + p["pos"][:t]
    for i in range(layers):
        q = f"layers.{i}."
        a = _norm(h, p[q + "ln1.scale"], p[q + "ln1.bias"])
        qq, kk, vv = ((a @ p[q + "w_qkv"]).split(d, dim=-1))
        qq, kk, vv = (z.reshape(b, t, heads, d // heads).transpose(1, 2) for z in (qq, kk, vv))
        logits = (qq @ kk.transpose(-1, -2)) / (d // heads) ** 0.5
        attn = torch.softmax(logits.masked_fill(~allowed, float("-inf")), dim=-1)
        ctx = (attn @ vv).transpose(1, 2).reshape(b, t, d)
        h = h + ctx @ p[q + "w_o"]
        f = _norm(h, p[q + "ln2.scale"], p[q + "ln2.bias"])
        h = h + torch.relu(f @ p[q + "w_f1"] + p[q + "b_f1"]) @ p[q + "w_f2"] + p[q + "b_f2"]
    return _norm(h, p["ln_f.scale"], p["ln_f.bias"])
