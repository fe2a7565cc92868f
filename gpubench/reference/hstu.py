"""HSTU (Zhai et al., ICML 2024, arXiv:2402.17152, section 3; the public code
github.com/facebookresearch/generative-recommenders,
``generative_recommenders/research/modeling/sequential/hstu.py``), one
sequence at a time and only its valid positions, in the precision the
caller sets (``reference.precision``).

Per sequence of ``L <= N`` items (``N = max_sequence_length``):
``x_0 = sqrt(D) E[ids] + P[0..L)``; per block ``n = LN(x)`` (no affine, eps
1e-6), ``U, V, Q, K = split(SiLU(n W_uvqk))``, per head ``A = SiLU(Q K^T +
rab) / N`` (no softmax) times the causal mask with its diagonal, ``x <- x +
W_o(U * LN(concat_h(A V))) + b_o``; ``rab[i, j] = pos_w[N - 1 + j - i] +
ts_w[bucket(tq_i - t_j)]``, ``bucket(g) = clamp(trunc(log(float32(max(|g|,
1))) / 0.301), 0, 128)``; the output over its L2 norm (clamped at 1e-6).

Departures: the last position's query time is its own time (the public
code reads the next column: a copy of the last time in a full window, the
zero padding in a shorter one); the served scores are ``row . rep + bias``;
no dropout. A history is a list of ids with its times in ``.times``
(``traffic/serve_batch_timed.py``)."""

from __future__ import annotations

from typing import Dict

import torch

BUCKETS = 128
EPS = 1e-6


def time_bucket(gap: torch.Tensor) -> torch.Tensor:
    """The public code's bucket of an int64 gap in seconds."""
    return (torch.log(gap.abs().clamp(min=1).to(torch.float32)) / 0.301).long().clamp(0, BUCKETS)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], eps=EPS)


def sequence(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Outputs ``[L, D]`` of one sequence: ``x [L, D]`` its items'
    embeddings, ``times [L + 1]`` int64 its times and then the last
    position's query time; ``p`` the leaves by dotted path."""
    n_win = int(cfg["max_sequence_length"])
    heads = int(cfg["num_heads"])
    length, d = x.shape
    dh = d // heads
    i = torch.arange(length, device=x.device)[:, None]
    j = torch.arange(length, device=x.device)[None, :]
    bucket = time_bucket(times[1:, None] - times[None, :length])
    h = x * d**0.5 + p["pos"][:length]
    for layer in range(int(cfg["num_layers"])):
        w = f"layers.{layer}."
        rab = p[w + "pos_w"][n_win - 1 + j - i] + p[w + "ts_w"][bucket]
        u, v, q, k = torch.nn.functional.silu(_norm(h) @ p[w + "w_uvqk"]).split(d, dim=-1)
        out = []
        for head in range(heads):
            c = slice(head * dh, (head + 1) * dh)
            a = torch.nn.functional.silu(q[:, c] @ k[:, c].T + rab) / n_win
            out.append((a * (j <= i)) @ v[:, c])
        h = h + (u * _norm(torch.cat(out, dim=-1))) @ p[w + "w_o"] + p[w + "b_o"]
    return h / h.norm(dim=-1, keepdim=True).clamp(min=EPS)


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Outputs ``[B, L, D]`` of ``x [B, L, D]`` and ``times [B, L + 1]``,
    each row a sequence of its own."""
    return torch.stack([sequence(cfg, p, x[b], times[b]) for b in range(x.shape[0])])


def representations(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories) -> torch.Tensor:
    """Each history's representation ``[U, D]``: the output at the last of
    its last ``N`` items, their times read from ``history.times`` (an empty
    history reads as item 0 at time 0). ``rows_fn(ids [M]) -> [M, D + 1]``."""
    n_win = int(cfg["max_sequence_length"])
    dev = p["pos"].device
    ids = [list(h[-n_win:]) or [0] for h in histories]
    rows = rows_fn(torch.tensor([i for row in ids for i in row], dtype=torch.int64, device=dev))[:, :-1]
    out, at = [], 0
    for h, row in zip(histories, ids):
        ts = list(h.times[-n_win:]) or [0]
        times = torch.tensor(ts + ts[-1:], dtype=torch.int64, device=dev)
        out.append(sequence(cfg, p, rows[at : at + len(row)], times)[-1])
        at += len(row)
    return torch.stack(out)
