"""sbr-rs's LSTM (``src/models/lstm.rs``): gates ``[i, f, g, o]``, or
``[i, g, o]`` for the Coupled variant, in ``w_x``, ``w_h`` ``[D, gates D]``
and ``b``."""

from __future__ import annotations

from typing import Dict


def _gates(cfg: Dict) -> int:
    return 3 if cfg["lstm_variant"] == "coupled" else 4


def hyperparameters(cfg: Dict):
    from sbr_rs_tpu_torch.models import lstm

    return lstm.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"]).lstm_variant(
        lstm.LSTMVariant(cfg["lstm_variant"])
    )


def tower_shapes(cfg: Dict):
    """The matrices' Glorot fans are per gate: ``(D, D)``."""
    d, gates = int(cfg["embedding_dim"]), _gates(cfg)
    return [("w_x", (d, gates * d), "w", (d, d)), ("w_h", (d, gates * d), "w", (d, d)),
            ("b", (gates * d,), "b", None)]


def tower_flops(cfg: Dict, positions: float, keys: float) -> float:
    """One timestep of one sequence: the input and the recurrent projections
    (``2 * d * gates * d`` each); the gate nonlinearities are not counted."""
    d = int(cfg["embedding_dim"])
    return positions * (4.0 * d * _gates(cfg) * d)
