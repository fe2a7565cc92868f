"""HSTU, the Hierarchical Sequential Transduction Unit (Zhai et al., "Actions
Speak Louder than Words", ICML 2024, arXiv:2402.17152; the public code is
github.com/facebookresearch/generative-recommenders). No counterpart in
:mod:`sbr_rs_tpu`.

The tower (:func:`.towers.hstu_apply`) reads each history's times as well
as its items: ``recommend_batch``, ``recommend`` and the representations
take ``timestamps`` (int seconds, one per item), and the evaluation passes
the test interactions' timestamps. Scores are the port's ``row . rep +
bias`` against the L2-normalised representation. ``fit`` is not supported:
the training windows carry no times.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.hstu_kernels import MAX_DIM
from . import base
from .towers import hstu_apply, init_hstu


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitHSTUModel`. Defaults: 2
    blocks, 1 head (base HSTU); each head's query, key and value widths are
    ``embedding_dim / num_heads``."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._num_layers = 2
        self._num_heads = 1

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

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "hstu"
        d["num_layers"] = self._num_layers
        d["num_heads"] = self._num_heads
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        hp._num_layers = d.get("num_layers", 2)
        hp._num_heads = d.get("num_heads", 1)
        return hp

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitHSTUModel":
        """Build a model on ``device``: the card unless the caller asks for
        ``"cpu"``. Raises when ``num_heads`` does not divide the embedding
        width, when that width is above the layer norms' 256
        (:class:`ImplicitHSTUModel`), and without CUDA for a ``cuda``
        build."""
        if self._item_embedding_dim % self._num_heads:
            raise ValueError(
                f"num_heads={self._num_heads} must divide embedding_dim={self._item_embedding_dim}"
            )
        return ImplicitHSTUModel(self, device)


class ImplicitHSTUModel(base.ImplicitSequenceModel):
    """HSTU sequence model for implicit feedback, served and evaluated on
    timed histories. The tower is :func:`hstu_apply`: plain PyTorch, except
    the two layer norms and the attention of each block, which run
    :mod:`..ops.hstu_kernels` on the card. The tower is given each window's
    length (its last position plus one; 1 for an empty history), so on the
    card the attention skips the padding, whose rows come out as zeros and
    feed no valid output. The kernels take rows of at most 256 floats on
    every device, so a model with a wider ``embedding_dim`` is refused here,
    before any parameter is drawn, rather than at its first call."""

    _reads_times = True

    def __init__(
        self, hyper: Hyperparameters, device: "torch.device | str", item_table: Optional[torch.Tensor] = None
    ):
        width = hyper._item_embedding_dim
        if width > MAX_DIM:
            raise ValueError(f"embedding_dim={width}: HSTU's layer norms take rows of at most {MAX_DIM} floats")
        super().__init__(hyper, device, item_table)

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        hp = self.hyper
        return init_hstu(generator, dim, hp._max_sequence_length, hp._num_layers, hp._num_heads, self.device)

    def _tower_fn(self):
        heads = self.hyper._num_heads

        def tower(params: Dict, x: torch.Tensor, times: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
            return hstu_apply(params, x, times, heads, lengths)

        return tower

    def fit(self, interactions) -> float:
        """Not supported: the training windows carry item ids only, and
        HSTU's tower needs each position's time."""
        raise NotImplementedError(
            "HSTU cannot be fitted yet: the training windows carry no timestamps "
            "(and HSTU's sampled-softmax loss is not ported)"
        )
