"""The comparison that decides ``correct`` in the serving cells: a sample of
the lists served in the window, drawn from the seed, against the plain
reference's exact top-k over the whole catalog (drawn again from the seed,
a block at a time), with TF32 off; or, as the control, with TF32 on."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import weights
from .reference import precision, topk, towers


def reference_lists(cfg: Dict, seed: int, w: Dict, device, histories: Sequence[Sequence[int]], k: int,
                    asked: torch.Tensor, tf32: bool = False, block_users: int = 1024):
    """``(values, ids, asked_scores)`` of the reference for ``histories``."""
    n, d = int(cfg["num_items"]), int(cfg["embedding_dim"])
    leaves = weights.tower_leaves(seed, cfg, w, device)
    out = []
    with precision(tf32), torch.no_grad():
        for a in range(0, len(histories), block_users):
            hs = histories[a : a + block_users]
            reps = towers.representations(
                cfg, leaves, lambda ids: weights.table_rows(seed, ids, n, d, w, device), hs
            )
            out.append(topk.catalog_topk(reps, hs, k, weights.chunks(seed, n, d, w, device), asked[a : a + block_users]))
    return tuple(torch.cat(parts) for parts in zip(*out))


def compare(cfg: Dict, seed: int, w: Dict, device, histories, served_ids: List[List[int]], k: int,
            served_vals: Optional[np.ndarray] = None, control: bool = False) -> Dict[str, float]:
    """``{"rank_gap", "score_err"}`` of the served lists (``score_err``
    only where scores were served). With ``control`` the reference in TF32
    takes the program's place: its own lists are judged instead."""
    n = int(cfg["num_items"])
    asked = torch.tensor([list(s[:k]) + [-1] * (k - len(s[:k])) for s in served_ids], dtype=torch.int64)
    ref_v, ref_i, asked_s = reference_lists(cfg, seed, w, device, histories, k, asked)
    if control:
        ctl_v, ctl_i, _ = reference_lists(cfg, seed, w, device, histories, k, asked, tf32=True)
        served_ids = ctl_i.tolist()
        asked = ctl_i
        _, _, asked_s = reference_lists(cfg, seed, w, device, histories, k, asked)
        served_vals = ctl_v.cpu().numpy() if served_vals is not None else None
    vals = None if served_vals is None else torch.as_tensor(np.asarray(served_vals, dtype=np.float32))
    rank_gap, score_err = topk.served_gaps(ref_v, asked_s, served_ids, n, vals)
    out = {"rank_gap": rank_gap}
    if vals is not None:
        out["score_err"] = score_err
    return out
