"""Causal self-attention (transformer) implicit-feedback sequence model.
Counterpart of :mod:`sbr_rs_tpu.models.attention`.

A family with no reference counterpart (``src/models`` has LSTM and EWMA):
a SASRec-style causal transformer encoder (:func:`.towers.attention_apply`)
on the same engine, losses, optimizers, evaluation and serving as the other
families.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from . import base
from .towers import attention_apply, init_attention


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitAttentionModel`. Defaults:
    2 encoder layers, 1 attention head, no dropout."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._num_layers = 2
        self._num_heads = 1
        self._dropout = 0.0

    def dropout(self, rate: float) -> "Hyperparameters":
        """Train-time dropout rate on the embedded input and each residual
        branch (the SASRec placement). 0.0 (default) draws nothing; serving
        and evaluation are deterministic whatever the rate."""
        if not 0.0 <= rate < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        self._dropout = float(rate)
        return self

    def num_layers(self, num_layers: int) -> "Hyperparameters":
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self._num_layers = int(num_layers)
        return self

    def num_heads(self, num_heads: int) -> "Hyperparameters":
        if num_heads < 1:
            raise ValueError("num_heads must be >= 1")
        self._num_heads = int(num_heads)
        return self

    @classmethod
    def random(cls, num_items: int, rng: "np.random.Generator | int | None" = None) -> "Hyperparameters":
        """Random hyperparameters for search: the common draws, then depth,
        heads (dividing the embedding width) and dropout, as the JAX
        package draws them."""
        rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        hp = cls._random_common(num_items, rng)
        hp._num_layers = int(rng.integers(1, 3))
        heads = [h for h in (1, 2, 4) if hp._item_embedding_dim % h == 0]
        hp._num_heads = int(rng.choice(heads))
        hp._dropout = float(rng.choice([0.0, 0.1, 0.2, 0.3, 0.5]))
        return hp

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "attention"
        d["num_layers"] = self._num_layers
        d["num_heads"] = self._num_heads
        d["dropout"] = self._dropout
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._num_layers = d.get("num_layers", 2)
        hp._num_heads = d.get("num_heads", 1)
        hp._dropout = d.get("dropout", 0.0)
        return hp

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitAttentionModel":
        """Build a model on ``device``: the card unless the caller asks for
        ``"cpu"``. Raises when ``num_heads`` does not divide the embedding
        width, and without CUDA for a ``cuda`` build."""
        if self._item_embedding_dim % self._num_heads:
            raise ValueError(
                f"num_heads={self._num_heads} must divide embedding_dim={self._item_embedding_dim}"
            )
        return ImplicitAttentionModel(self, device)


class ImplicitAttentionModel(base.ImplicitSequenceModel):
    """Causal-transformer sequence model for implicit feedback. The tower is
    :func:`attention_apply`, plain PyTorch on every device; its dropout
    draws from the model's dropout generator in ``fit`` only."""

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        hp = self.hyper
        return init_attention(
            generator, dim, hp._max_sequence_length, hp._num_layers, hp._num_heads, self.device
        )

    def _tower_fn(self):
        return functools.partial(
            attention_apply, num_heads=self.hyper._num_heads, dropout=self.hyper._dropout
        )
