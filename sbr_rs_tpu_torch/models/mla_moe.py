"""DeepSeek-V3's decoder block as a user tower: multi-head latent attention
(MLA) and a mixture of sigmoid-routed experts beside shared ones, at
Moonlight-16B-A3B's published sizes by default. No counterpart in
:mod:`sbr_rs_tpu`.

The recommender is HLLM's user model (Chen et al., arXiv:2409.12740): a
decoder-only LLM reads a window of item embeddings (the item table's rows,
with no token embedding and no LM head), and its last hidden state at the
last valid position is the user's representation, scored against the item
table as every family is (``row . rep + bias``). The tower is
:func:`.towers.mla_moe_apply`, plain PyTorch on every device, given each
window's length so that the per-position work never sees the padding.
Serving, ``predict``, evaluation and checkpoints are the base class's;
``fit`` is not supported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import base
from .towers import MLAMoEShape, init_mla_moe, mla_moe_apply


class Hyperparameters(base.Hyperparameters):
    """Hyperparameters for the :class:`ImplicitMLAMoEModel`: the shared ones,
    and the block's sizes (:class:`.towers.MLAMoEShape`, Moonlight-16B-A3B's
    published values unless :meth:`shape` changes them). The hidden size is
    ``embedding_dim``."""

    def __init__(self, num_items: int, max_sequence_length: int):
        super().__init__(num_items, max_sequence_length)
        self._shape = MLAMoEShape()

    def shape(self, **sizes) -> "Hyperparameters":
        """Change the block's sizes by their ``config.json`` names (the
        fields of :class:`.towers.MLAMoEShape`); raises ``ValueError`` on an
        unknown name or a size out of range."""
        unknown = set(sizes) - {f.name for f in dataclasses.fields(MLAMoEShape)}
        if unknown:
            raise ValueError(f"unknown MLA + MoE sizes: {sorted(unknown)}")
        self._shape = dataclasses.replace(self._shape, **sizes)
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["model_type"] = "mla_moe"
        d.update(dataclasses.asdict(self._shape))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Hyperparameters":
        hp = cls._from_dict_common(d)
        return hp.shape(**{f.name: d[f.name] for f in dataclasses.fields(MLAMoEShape) if f.name in d})

    def build(self, device: "torch.device | str" = "cuda") -> "ImplicitMLAMoEModel":
        """Build a model on ``device``: the card unless the caller asks for
        ``"cpu"``. Raises without CUDA for a ``cuda`` build."""
        return ImplicitMLAMoEModel(self, device)


class ImplicitMLAMoEModel(base.ImplicitSequenceModel):
    """The MLA + MoE sequence model for implicit feedback, served and
    evaluated on item histories. Every MoE layer holds all its routed
    experts. The tower reads each window's length (``_reads_lengths``)."""

    _reads_lengths = True

    def _init_tower(self, generator: torch.Generator, dim: int) -> Dict:
        return init_mla_moe(generator, dim, self.hyper._shape, self.device)

    def _tower_fn(self):
        shape = self.hyper._shape

        def tower(params: Dict, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
            return mla_moe_apply(params, x, shape, lengths)

        return tower

    def fit(self, interactions) -> float:
        """Not supported: HLLM's next-item contrastive loss is not ported."""
        raise NotImplementedError("the MLA + MoE family cannot be fitted: it serves and evaluates only")
