"""The yardstick's peaks and the operations and bytes each function needs,
counted once from shapes, whatever implements it: one multiply-add is two
operations, each input byte is read once and each output byte written once.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit; the
numbers ``chip_smoke.py`` uses): 495 TFLOP/s on the tensor cores in TF32,
3.35 TB/s of HBM3. Every share here is against the TF32 peak: a float32
function counted once, not by the products a route needs."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import spec

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the chip could take, and what bounds it."""
    by_ops, by_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def catalog_scores(n: int, u: int, cc: int) -> float:
    """Scores of ``u`` users against ``n`` rows of ``cc`` columns (the
    embedding and the bias against a representation with a trailing 1)."""
    return 2.0 * n * u * cc


def k4_bytes(n: int, u: int, cc: int, itemsize: int, sub: int, group: int) -> float:
    """K4 (``score_submax_groupmax``): the table read once, the users'
    representations read once, the f32 subgroup and group maxima written
    once."""
    return n * cc * itemsize + u * cc * 4 + 4.0 * u * (-(-n // sub) + -(-n // group))


def serve_batch(cfg: Dict, history_lengths: Iterable[int], n: int) -> float:
    """One served batch: the tower over each history (the last ``T`` items,
    up to the position whose state is the representation) and the scores
    of every user against the whole catalog; the family's file counts the
    tower (``families/<family>.py tower_flops``)."""
    t = int(cfg["max_sequence_length"])
    lens = [min(int(x), t) for x in history_lengths]
    keys = sum(x * (x + 1) / 2 for x in lens)
    cc = int(cfg["embedding_dim"]) + 1
    tower = spec.family_module(cfg["family"]).tower_flops(cfg, sum(lens), keys)
    return tower + catalog_scores(n, len(lens), cc)
