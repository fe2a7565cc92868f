"""HSTU's forward pass as written in the paper (Zhai et al., "Actions Speak
Louder than Words", ICML 2024, arXiv:2402.17152, section 3) and its public
code (github.com/facebookresearch/generative-recommenders,
``generative_recommenders/research/modeling/sequential/hstu.py``): plain
``torch`` in float32 with TF32 off, one sequence at a time, only its valid
positions. It imports nothing of the port and nothing of JAX.

Per sequence of ``L <= N`` items (``N = max_sequence_length``, the window):
``x_0 = sqrt(D) E[ids] + P[0..L)``; per block ``n = LN(x)`` (no affine, eps
1e-6), ``U, V, Q, K = split(SiLU(n W_uvqk))``, per head ``A = SiLU(Q K^T +
rab) / N`` (no softmax; the divisor is the window, not ``L``) times the
causal mask with its diagonal, ``x <- x + W_o(U * LN(concat_h(A V))) + b_o``;
``rab[i, j] = pos_w[N - 1 + j - i] + ts_w[bucket(tq_i - t_j)]`` with
``bucket(g) = clamp(trunc(log(float32(max(|g|, 1))) / 0.301), 0, 128)``.
The output is each position's state over its L2 norm (clamped at 1e-6).

Departures from the public code:

* the query time ``tq_i`` is the next event's time ``t_{i+1}``, as the
  public code's ``ext_timestamps[:, 1:]``, but the last position's is its
  own time for every history (the public code reads the next column: a
  copy of the last time in a full window, the zero padding in a shorter
  history);
* the served scores are the port's ``row . rep + bias`` (the public model
  scores L2-normalised items over a temperature), not computed here;
* no dropout (serving).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch

BUCKETS = 128
EPS = 1e-6


@contextlib.contextmanager
def _fp32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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
    with _fp32():
        return torch.stack([sequence(cfg, p, x[b], times[b]) for b in range(x.shape[0])])


def representations(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories: Sequence[Sequence[int]],
                    timestamps: Sequence[Sequence[int]]) -> torch.Tensor:
    """Each history's representation ``[U, D]``: the output at the last of
    its last ``N`` items (an empty history reads as item 0 at time 0).
    ``rows_fn(ids [M]) -> [M, D + 1]`` (embedding columns, then the bias)."""
    n_win = int(cfg["max_sequence_length"])
    dev = p["pos"].device
    out = []
    with _fp32():
        for ids, ts in zip(histories, timestamps):
            ids, ts = (list(ids[-n_win:]) or [0]), (list(ts[-n_win:]) or [0])
            x = rows_fn(torch.tensor(ids, dtype=torch.int64, device=dev))[:, :-1]
            times = torch.tensor(ts + ts[-1:], dtype=torch.int64, device=dev)
            out.append(sequence(cfg, p, x, times)[-1])
    return torch.stack(out)
