"""Negative sampling: the WARP adaptive-selection rule. Counterpart of
:mod:`sbr_rs_tpu.ops.sampling`.

Reference ``src/models/sequence_model.rs:47-68``: draw up to 5 uniform
negatives; accept the FIRST whose hinge margin is violated
(``1 - pos + neg > 0``); if none violates, keep the LAST draw (which then
contributes zero hinge loss). All K candidate scores are computed at once
and the rule is applied to them together.
"""

from __future__ import annotations

import torch

WARP_CANDIDATES = 5  # reference draws at most 5 (src/models/sequence_model.rs:58)


def warp_select(pos_scores: torch.Tensor, cand_scores: torch.Tensor) -> torch.Tensor:
    """Index of the accepted candidate per position.

    ``pos_scores [...]``, ``cand_scores [..., K]`` → int32 ``[...]`` in
    ``[0, K)``: the first k with ``1 - pos + cand_k > 0``, else ``K - 1``.
    """
    k = cand_scores.shape[-1]
    viol = (1.0 - pos_scores[..., None] + cand_scores) > 0.0
    first = viol.to(torch.uint8).argmax(dim=-1)  # the first maximum
    return torch.where(viol.any(dim=-1), first, k - 1).to(torch.int32)


def warp_select_onehot(pos_scores: torch.Tensor, cand_scores: torch.Tensor) -> torch.Tensor:
    """One-hot (float32, ``[..., K]``) of :func:`warp_select`'s choice: the
    first violator is "violates AND no violation before it" (an exclusive
    cumsum along K); the last draw when nothing violates."""
    viol = (1.0 - pos_scores[..., None] + cand_scores) > 0.0
    vi = viol.to(torch.float32)
    prior = torch.cumsum(vi, dim=-1) - vi  # violations strictly before k
    first = vi * (prior == 0.0)
    first[..., -1] += 1.0 - vi.amax(dim=-1)  # nothing violates: the last draw
    return first
