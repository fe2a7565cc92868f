"""Pairwise ranking losses. Counterpart of :mod:`sbr_rs_tpu.ops.losses`.

Exact formulas from the reference (``src/models/lstm.rs:313-320``,
``src/models/ewma.rs:328-335``):

* BPR:   ``sigmoid(neg - pos)`` — the reference's literal formula (a sigmoid
  of the score difference), not the textbook ``-log sigmoid(pos - neg)``.
* Hinge / WARP: ``relu(1 + neg - pos)``.

WARP differs from Hinge only in how the negative is chosen
(:mod:`.sampling`).
"""

from __future__ import annotations

import torch

from ..models import Loss


def pairwise_loss(
    loss: Loss, positive_scores: torch.Tensor, negative_scores: torch.Tensor
) -> torch.Tensor:
    """Elementwise pairwise loss for (positive, negative) score pairs."""
    if loss == Loss.BPR:
        return torch.sigmoid(negative_scores - positive_scores)
    if loss in (Loss.HINGE, Loss.WARP):
        return torch.relu(1.0 + negative_scores - positive_scores)
    raise ValueError(f"Unknown loss: {loss}")
