"""The whole step's share of the card's peak: the operations the window's
work needs, counted once from shapes (``gpubench/flops.py``), over the
window's wall time and the dense TF32 peak, in %."""

from gpubench import flops


def read(r, name):
    if not r.get("flops") or r["window_s"] <= 0:
        return None
    return 100.0 * r["flops"] / r["window_s"] / flops.PEAK_TF32_FLOPS
