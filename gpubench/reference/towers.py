"""The towers as their papers write them, one sequence a row, as served
(no dropout).

* LSTM (sbr-rs ``src/models/lstm.rs``; Hochreiter and Schmidhuber): gates
  ``[i, f, g, o]`` in ``w_x``, ``w_h`` ``[D, 4D]`` and ``b [4D]``, or ``[i,
  g, o]`` with ``f = 1 - i`` (Coupled); ``h`` and ``c`` start at zero.
* SASRec (Kang and McAuley 2018, section III): learned positions, pre-LN
  blocks of one causal attention and a point-wise ReLU FFN, each branch
  added back, a final layer norm (eps 1e-6, the port's)."""

from __future__ import annotations

from typing import Dict

import torch


def lstm(p: Dict[str, torch.Tensor], x: torch.Tensor, coupled: bool):
    """Hidden states ``[B, T, D]`` of ``x [B, T, D]``."""
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


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-6)


def sasrec(p: Dict[str, torch.Tensor], x: torch.Tensor, layers: int, heads: int = 1):
    """Outputs ``[B, T, D]`` of ``x [B, T, D]``."""
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


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x):
    """The configuration's tower."""
    if cfg["family"] == "lstm":
        return lstm(p, x, cfg["lstm_variant"] == "coupled")
    return sasrec(p, x, int(cfg["num_layers"]), int(cfg["num_heads"]))


def representations(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories) -> torch.Tensor:
    """Each history's representation ``[U, D]``: the tower's state at the
    last of its last ``T`` items. ``rows_fn(ids [M]) -> [M, D + 1]``."""
    t = int(cfg["max_sequence_length"])
    u = len(histories)
    dev = p[next(iter(p))].device
    lens = [max(1, min(len(h), t)) for h in histories]
    ids = torch.zeros((u, t), dtype=torch.int64)
    for r, h in enumerate(histories):
        tail = list(h[-t:]) or [0]
        ids[r, : len(tail)] = torch.tensor(tail, dtype=torch.int64)
    ids = ids.to(dev)
    emb = rows_fn(ids.reshape(-1))[:, :-1].reshape(u, t, -1)
    hidden = apply(cfg, p, emb)
    last = torch.tensor(lens, device=dev) - 1
    return hidden[torch.arange(u, device=dev), last]
