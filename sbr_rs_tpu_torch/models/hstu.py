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

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..errors import InvalidPredictionValue
from ..ops.hstu_kernels import MAX_DIM
from ..utils.metrics import span
from ..utils.precision import fp32_matmul
from . import base
from .towers import hstu_apply, init_hstu


def _window_ids(flat: np.ndarray, lens: np.ndarray, t: int) -> np.ndarray:
    """The ids the tower reads: each history's last ``t`` (all of ``flat``
    when no history is longer)."""
    if not lens.size or lens.max() <= t:
        return flat
    rank = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
    return flat[rank >= np.repeat(lens - t, lens)]


def _windows(
    flat: np.ndarray, times: np.ndarray, lens: np.ndarray, t: int, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ids [U, t]``, ``times [U, t + 1]`` and ``last [U]`` on ``device``,
    gathered there from one copy of the flat rows (``flat``, ``times``: the
    histories end to end), with no host pass over ``U x t``. Row ``r`` holds
    history ``r``'s last ``keep = min(lens[r], t)`` ids left-aligned, then
    0; its times likewise, then its last time to the end of the row, so
    column ``i + 1`` is position ``i``'s query time and the last valid
    position's is its own; ``last[r] = max(keep - 1, 0)``. An empty history
    reads as item 0 at time 0."""
    u = len(lens)
    keep = np.minimum(lens, t)
    last = torch.from_numpy(np.maximum(keep - 1, 0)).to(device)
    if not flat.size:
        zeros = torch.zeros((u, t + 1), dtype=torch.int64, device=device)
        return zeros[:, :t], zeros, last
    meta = torch.from_numpy(np.stack([np.where(keep > 0, np.cumsum(lens) - keep, 0), keep], axis=1)).to(device)
    first, kept = meta[:, :1], meta[:, 1:]
    col = torch.arange(t + 1, device=device)
    src = first + torch.minimum(col, kept - 1).clamp_(min=0)
    ids = torch.from_numpy(flat).to(device)[src[:, :t]].masked_fill_(col[:t] >= kept, 0)
    rows = torch.from_numpy(times).to(device)[src].masked_fill_(kept == 0, 0)
    return ids, rows, last


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
    the two layer norms a block, which run :mod:`..ops.hstu_kernels` on the
    card. Those take rows of at most 256 floats on every device, so a model
    with a wider ``embedding_dim`` is refused here, before any parameter is
    drawn, rather than at its first call."""

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
        return functools.partial(hstu_apply, num_heads=self.hyper._num_heads)

    def _representations(
        self, flat: np.ndarray, lens: np.ndarray, timestamps: Optional[np.ndarray] = None
    ) -> torch.Tensor:
        """The base class's representations over timed histories
        (``timestamps`` as :func:`.base._flatten_times` gives them;
        ``ValueError`` without). The windows of ids and times are laid out
        on the device (:func:`_windows`), and nothing here waits for the
        tower: only the ids the windows read are checked, on the host."""
        if timestamps is None:
            raise ValueError(f"{type(self).__name__} needs the histories' timestamps")
        t = self.hyper._max_sequence_length
        n = self.hyper._num_items
        u = len(lens)
        with span("tower.inputs"):
            window = _window_ids(flat, lens, t)
            if window.size and (window.min() < 0 or window.max() >= n):
                raise InvalidPredictionValue(f"History contains item ids outside [0, {n}).")
            ids, times, last = _windows(flat, timestamps, lens, t, self.device)
        emb = self._rows(ids.reshape(-1))[:, :-1]
        with fp32_matmul():
            hidden = self._tower_fn()(self._params["tower"], emb.reshape(u, t, -1), times)
        return hidden[torch.arange(u, device=self.device), last]

    def fit(self, interactions) -> float:
        """Not supported: the training windows carry item ids only, and
        HSTU's tower needs each position's time."""
        raise NotImplementedError(
            "HSTU cannot be fitted yet: the training windows carry no timestamps "
            "(and HSTU's sampled-softmax loss is not ported)"
        )
