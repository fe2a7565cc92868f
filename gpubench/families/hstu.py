"""HSTU (Zhai et al., ICML 2024, arXiv:2402.17152; generative-recommenders'
``hstu.py``): learned positions, then blocks of a gated pointwise attention
with no softmax over a relative bias of positions and bucketed time gaps;
each head ``embedding_dim / num_heads`` wide. Its histories carry times
(``traffic/serve_batch_timed.py``)."""

from __future__ import annotations

from typing import Dict

TIME_BUCKETS = 129


def hyperparameters(cfg: Dict):
    from sbr_rs_tpu_torch.models import hstu

    return (
        hstu.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"])
        .num_layers(cfg["num_layers"])
        .num_heads(cfg["num_heads"])
    )


def tower_shapes(cfg: Dict):
    """A matrix's Glorot fans are its own shape; the relative biases
    ``pos_w`` and ``ts_w`` are drawn as biases (``tower_bias_std``)."""
    d, n = int(cfg["embedding_dim"]), int(cfg["max_sequence_length"])
    out = [("pos", (n, d), "pos", None)]
    for i in range(int(cfg["num_layers"])):
        p = f"layers.{i}."
        out += [
            (p + "w_uvqk", (d, 4 * d), "w", (d, 4 * d)), (p + "w_o", (d, d), "w", (d, d)),
            (p + "b_o", (d,), "b", None), (p + "pos_w", (2 * n - 1,), "b", None),
            (p + "ts_w", (TIME_BUCKETS,), "b", None),
        ]
    return out


def tower_flops(cfg: Dict, positions: float, keys: float) -> float:
    """One position of a block: the U, V, Q, K projection (``8 d^2``) and
    the output projection (``2 d^2``); each attended key ``Q K^T`` and
    ``A V`` over all heads (``4 d``). Bias, SiLU and norms are not counted."""
    d, layers = int(cfg["embedding_dim"]), int(cfg["num_layers"])
    return layers * (10.0 * d * d * positions + 4.0 * d * keys)
