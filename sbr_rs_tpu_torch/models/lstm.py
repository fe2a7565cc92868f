"""LSTM-based implicit-feedback sequence model. Counterpart of
:mod:`sbr_rs_tpu.models.lstm`.

Reference: ``src/models/lstm.rs`` -- an LSTM over the user's interaction
sequence predicts the next item; Normal and Coupled (forget = 1 - input)
cell variants (``src/models/lstm.rs:28-35``).
"""

from __future__ import annotations

import enum
import functools
from typing import Dict

import numpy as np
import torch

from ..ops.lstm_kernels import lstm_apply_kernel
from . import base
from .towers import init_lstm


class LSTMVariant(enum.Enum):
    """Type of LSTM layer to use (reference ``src/models/lstm.rs:28-35``)."""

    NORMAL = "normal"
    COUPLED = "coupled"


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitLSTMModel`
    (reference ``src/models/lstm.rs:38-172``). Default variant: Coupled
    (``src/models/lstm.rs:63``)."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._lstm_variant = LSTMVariant.COUPLED
        self._use_pallas: "bool | None" = None

    def lstm_variant(self, variant: LSTMVariant) -> "Hyperparameters":
        self._lstm_variant = variant
        return self

    def use_pallas(self, enabled: "bool | None") -> "Hyperparameters":
        """The JAX package's switch between its Pallas LSTM kernel and its
        ``lax.scan`` tower. Recorded (``to_dict`` writes it, so a checkpoint
        keeps it for either package) and ignored: the recurrence is the CUDA
        kernels K1/K2 for a model on ``cuda`` whatever the flag, and the
        plain PyTorch loops on ``cpu``."""
        self._use_pallas = enabled
        return self

    @classmethod
    def random(cls, num_items: int, rng: "np.random.Generator | int | None" = None) -> "Hyperparameters":
        """Random hyperparameters for search (reference
        ``src/models/lstm.rs:141-172``): the common draws, then the variant,
        as the JAX package draws them."""
        rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        hp = cls._random_common(num_items, rng)
        hp._lstm_variant = LSTMVariant.NORMAL if rng.random() < 0.5 else LSTMVariant.COUPLED
        return hp

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["lstm_variant"] = self._lstm_variant.value
        d["use_pallas"] = self._use_pallas
        d["model_type"] = "lstm"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._lstm_variant = LSTMVariant(d["lstm_variant"])
        hp._use_pallas = d.get("use_pallas")
        return hp

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitLSTMModel":
        """Build a model on ``device`` (reference ``src/models/lstm.rs:197-201``):
        the card unless the caller asks for ``"cpu"``. Without CUDA a
        ``cuda`` build raises; nothing falls back to the CPU."""
        return ImplicitLSTMModel(self, device)


class ImplicitLSTMModel(base.ImplicitSequenceModel):
    """An LSTM-based sequence model for implicit feedback
    (reference ``src/models/lstm.rs:385-416``). The tower, for training and
    serving, is :func:`lstm_apply_kernel` on every device: the recurrence
    (forward, and backward in ``fit``) is the CUDA kernels for a model on
    ``cuda``, the plain PyTorch loops on ``cpu``."""

    def _coupled(self) -> bool:
        return self.hyper._lstm_variant == LSTMVariant.COUPLED

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        return init_lstm(generator, dim, self._coupled(), self.device)

    def _tower_fn(self):
        return functools.partial(lstm_apply_kernel, coupled=self._coupled())
