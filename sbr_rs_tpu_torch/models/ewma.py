"""Model based on an exponentially-weighted average (EWMA) of past
embeddings. Counterpart of :mod:`sbr_rs_tpu.models.ewma`.

Reference: ``src/models/ewma.rs``: the user state is ``u_1 = i_1``,
``u_t = sigmoid(alpha) * u_{t-1} + (1 - sigmoid(alpha)) * i_t`` with a
learnable per-dimension decay ``alpha`` (``src/models/ewma.rs:302-313``).
The reference's unused ``fc1``/``fc2`` parameters are not reproduced, as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import base
from .towers import ewma_apply, init_ewma


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitEWMAModel`
    (reference ``src/models/ewma.rs:44-165``); ``random`` draws the common
    knobs only, as the JAX package's."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._alpha_init = 0.0

    def alpha_init(self, value: float) -> "Hyperparameters":
        """Initial per-dimension decay logit (default 0.0: the reference's
        zero init, a decay of sigmoid(0) = 0.5)."""
        self._alpha_init = float(value)
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "ewma"
        d["alpha_init"] = self._alpha_init
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._alpha_init = d.get("alpha_init", 0.0)
        return hp

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitEWMAModel":
        """Build a model on ``device`` (reference ``src/models/ewma.rs:200-206``):
        the card unless the caller asks for ``"cpu"``. Without CUDA a
        ``cuda`` build raises; nothing falls back to the CPU."""
        return ImplicitEWMAModel(self, device)


class ImplicitEWMAModel(base.ImplicitSequenceModel):
    """EWMA sequence model for implicit feedback (reference
    ``src/models/ewma.rs:399-436``). The tower is :func:`ewma_apply`, plain
    PyTorch on every device."""

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        return init_ewma(generator, dim, self.device, alpha_init=self.hyper._alpha_init)

    def _tower_fn(self):
        return ewma_apply
