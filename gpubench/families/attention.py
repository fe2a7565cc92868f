"""The port's attention family, SASRec's blocks (Kang and McAuley 2018):
learned positions, pre-LN blocks of one causal attention and a point-wise
FFN, a final layer norm."""

from __future__ import annotations

from typing import Dict


def hyperparameters(cfg: Dict):
    from sbr_rs_tpu_torch.models import attention

    return (
        attention.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"])
        .num_layers(cfg["num_layers"])
        .num_heads(cfg["num_heads"])
        .dropout(cfg["dropout"])
    )


def tower_shapes(cfg: Dict):
    """A matrix's Glorot fans are its own shape."""
    d = int(cfg["embedding_dim"])

    def w(path, shape):
        return (path, shape, "w", shape)

    out = [("pos", (int(cfg["max_sequence_length"]), d), "pos", None)]
    for i in range(int(cfg["num_layers"])):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), "scale", None), (p + "ln1.bias", (d,), "b", None),
            w(p + "w_qkv", (d, 3 * d)), w(p + "w_o", (d, d)),
            (p + "ln2.scale", (d,), "scale", None), (p + "ln2.bias", (d,), "b", None),
            w(p + "w_f1", (d, d)), (p + "b_f1", (d,), "b", None),
            w(p + "w_f2", (d, d)), (p + "b_f2", (d,), "b", None),
        ]
    return out + [("ln_f.scale", (d,), "scale", None), ("ln_f.bias", (d,), "b", None)]


def tower_flops(cfg: Dict, positions: float, keys: float) -> float:
    """One position of the block stack: the q/k/v and output projections
    (``8 d^2``), the point-wise FFN (``4 d^2``), and the logits and the
    context over the attended positions (``4 d`` a key)."""
    d, layers = int(cfg["embedding_dim"]), int(cfg["num_layers"])
    return positions * (layers * (12.0 * d * d)) + layers * 4.0 * d * keys
