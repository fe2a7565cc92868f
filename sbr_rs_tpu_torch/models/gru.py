"""GRU-based implicit-feedback sequence model (GRU4Rec-style). Counterpart
of :mod:`sbr_rs_tpu.models.gru`.

A family with no reference counterpart (``src/models`` has LSTM and EWMA):
the GRU cell of GRU4Rec on the same engine, losses, optimizers, evaluation
and serving as the other families; only the tower differs
(:func:`.towers.gru_apply`).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import base
from .towers import gru_apply, init_gru


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitGRUModel`: the LSTM family's
    knobs (reference ``src/models/lstm.rs:38-172``) without the cell
    variant; ``random`` draws the common knobs only, as the JAX package's."""

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "gru"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        return cls._from_dict_common(d)

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitGRUModel":
        """Build a model on ``device``: the card unless the caller asks for
        ``"cpu"``. Without CUDA a ``cuda`` build raises; nothing falls back
        to the CPU."""
        return ImplicitGRUModel(self, device)


class ImplicitGRUModel(base.ImplicitSequenceModel):
    """GRU sequence model for implicit feedback. The tower is
    :func:`gru_apply`, plain PyTorch on every device."""

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        return init_gru(generator, dim, self.device)

    def _tower_fn(self):
        return gru_apply
