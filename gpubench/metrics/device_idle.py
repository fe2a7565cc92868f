"""Share of the traced window in which no operation ran on the device:
one less the union of the kernels', copies' and sets' intervals over the
window, in %."""


def read(r, name):
    w = r["window"]
    if w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
