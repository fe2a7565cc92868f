"""Host ms a unit (a batch or a request) of the serving call's request
preparation (``models/base.py``): ``_flatten`` and ``_seen_rows`` (span
``sbr.serve.prepare``), ``_pad_histories``, the id check and the two
host-to-device copies of the tower's inputs (``sbr.tower.inputs``; the
second copy waits for the tower's kernels). ``None`` where the program
records no such span."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    s = spans.host_s(r["window"], ("serve.prepare", "tower.inputs"))
    if not units or s is None:
        return None
    return 1e3 * s / units
