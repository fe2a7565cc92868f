"""Traffic generators, all on the host from the run's seed.

``zipf_ids`` is the inverse-CDF power law of
``sbr_rs_tpu_torch.datasets.synthetic_interactions`` (copied: the yardstick
may not change when the program does); ``histories`` is the serving
history generator of ``benches/serving.py`` with its item ids drawn from
that law and its lengths a fixed multiset, so every seed serves the same
sizes in another order."""

from __future__ import annotations

from typing import List

import numpy as np


def zipf_ids(rng: np.random.Generator, count: int, num_items: int, exponent: float) -> np.ndarray:
    """``count`` item ids with ``p(rank) ~ rank ** -exponent`` over
    ``[0, num_items)``, id ``rank - 1`` (popular items have small ids)."""
    u = rng.random(count)
    s = float(exponent)
    if abs(s - 1.0) < 1e-9:
        ranks = np.floor(num_items**u).astype(np.int64)
    else:
        ranks = np.floor(((num_items ** (1.0 - s) - 1.0) * u + 1.0) ** (1.0 / (1.0 - s))).astype(np.int64)
    return np.clip(ranks - 1, 0, num_items - 1)


def lengths(rng: np.random.Generator, count: int, lo: int, hi: int) -> np.ndarray:
    """``count`` history lengths: ``lo..hi`` repeated evenly (a fixed
    multiset for every seed), in the seed's order."""
    return rng.permutation(np.resize(np.arange(lo, hi + 1, dtype=np.int64), count))


def histories(
    rng: np.random.Generator, count: int, num_items: int, lo: int, hi: int, exponent: float
) -> List[List[int]]:
    """``count`` histories as lists of Python ints (what the serving API
    takes), lengths from :func:`lengths`, ids from :func:`zipf_ids`."""
    lens = lengths(rng, count, lo, hi)
    flat = zipf_ids(rng, int(lens.sum()), num_items, exponent).tolist()
    out, at = [], 0
    for n in lens.tolist():
        out.append(flat[at : at + n])
        at += n
    return out
