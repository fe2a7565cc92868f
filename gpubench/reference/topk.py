"""The exact top-k of a whole catalog for a few users, in blocks of the
table drawn again from the seed: scores ``rep . emb + bias``, the user's
seen items excluded, the ``k`` best kept across blocks."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch


def catalog_topk(
    reps: torch.Tensor,
    seen: Sequence[Sequence[int]],
    k: int,
    blocks: Iterable[Tuple[int, torch.Tensor]],
    asked: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(values [U, k], ids [U, k], asked_scores)`` over ``blocks`` of
    ``(first row, rows [R, D + 1])`` covering the catalog once.
    ``asked [U, A]`` are ids whose scores are wanted as well (``-inf`` for
    a seen id, ``nan`` for one outside the catalog)."""
    u, dev = reps.shape[0], reps.device
    aug = torch.cat([reps, reps.new_ones((u, 1))], dim=1)
    vals = torch.full((u, k), float("-inf"), device=dev)
    ids = torch.full((u, k), -1, dtype=torch.int64, device=dev)
    asked = asked.to(dev)
    asked_scores = torch.full(asked.shape, float("nan"), device=dev)
    seen_ids = torch.cat([torch.tensor(list(s), dtype=torch.int64) for s in seen]).to(dev)
    seen_user = torch.cat([torch.full((len(s),), r, dtype=torch.int64) for r, s in enumerate(seen)]).to(dev)
    for lo, rows in blocks:
        hi = lo + rows.shape[0]
        scores = aug @ rows.T
        inside = (seen_ids >= lo) & (seen_ids < hi)
        scores[seen_user[inside], seen_ids[inside] - lo] = float("-inf")
        here = (asked >= lo) & (asked < hi)
        r_idx = torch.arange(u, device=dev)[:, None].expand_as(asked)
        asked_scores[here] = scores[r_idx[here], asked[here] - lo]
        bv, bi = torch.topk(scores, min(k, rows.shape[0]), dim=1)
        mv = torch.cat([vals, bv], dim=1)
        mi = torch.cat([ids, bi + lo], dim=1)
        vals, p = torch.topk(mv, k, dim=1)
        ids = torch.gather(mi, 1, p)
    return vals, ids, asked_scores


def served_gaps(
    ref_vals: torch.Tensor, asked_scores: torch.Tensor, served_ids: List[List[int]], num_items: int,
    served_vals: "torch.Tensor | None" = None,
) -> Tuple[float, float]:
    """``(rank_gap, score_err)`` of served lists against the reference:
    the widest gap by which a served item's reference score lies below the
    reference's score at the same rank, and the widest distance between a
    served score and the reference's score of that item, both relative to
    the user's best reference score. A list that is short, repeats an
    item, or holds a seen item or one outside the catalog reads ``inf``."""
    scale = ref_vals[:, :1].abs().clamp(min=torch.finfo(torch.float32).tiny)
    k = ref_vals.shape[1]
    bad = [len(s) != k or len(set(s)) != len(s) or any(not 0 <= i < num_items for i in s) for s in served_ids]
    gap = (ref_vals - asked_scores) / scale
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")), gap)
    rank_gap = float(gap.max()) if gap.numel() else 0.0
    if any(bad):
        rank_gap = float("inf")
    score_err = 0.0
    if served_vals is not None:
        err = ((served_vals.to(asked_scores.device) - asked_scores).abs() / scale)
        err = torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)
        score_err = float(err.max()) if err.numel() else 0.0
    return max(rank_gap, 0.0), score_err
