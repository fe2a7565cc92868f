"""The towers as their papers write them, one sequence a row, as served (no
dropout): each family's in ``reference/<family>.py``, found by the
configuration's ``family``. A family's file defines ``apply(cfg, p, x)``,
its outputs ``[B, T, D]`` of ``x [B, T, D]``, and may define its own
``representations(cfg, p, rows_fn, histories)`` for histories that carry
more than item ids. A family with no file raises: none is run as another."""

from __future__ import annotations

from typing import Dict

import torch

from .. import spec


def apply(cfg: Dict, p: Dict[str, torch.Tensor], x):
    """The configuration's tower."""
    return spec.reference_module(cfg["family"]).apply(cfg, p, x)


def representations(cfg: Dict, p: Dict[str, torch.Tensor], rows_fn, histories) -> torch.Tensor:
    """Each history's representation ``[U, D]``: the tower's state at the
    last of its last ``T`` items (or the family's own ``representations``).
    ``rows_fn(ids [M]) -> [M, D + 1]``."""
    family = spec.reference_module(cfg["family"])
    if hasattr(family, "representations"):
        return family.representations(cfg, p, rows_fn, histories)
    t = int(cfg["max_sequence_length"])
    u = len(histories)
    dev = p[next(iter(p))].device
    lens = [max(1, min(len(h), t)) for h in histories]
    ids = torch.zeros((u, t), dtype=torch.int64)
    for r, h in enumerate(histories):
        tail = list(h[-t:]) or [0]
        ids[r, : len(tail)] = torch.tensor(tail, dtype=torch.int64)
    ids = ids.to(dev)
    emb = rows_fn(ids.reshape(-1))[:, :-1].reshape(u, t, -1)
    hidden = family.apply(cfg, p, emb)
    last = torch.tensor(lens, device=dev) - 1
    return hidden[torch.arange(u, device=dev), last]
