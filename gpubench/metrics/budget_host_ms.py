"""Host ms a unit (a batch or a request) of the serving budgets
(``models/base.py _serving_budgets``, span ``sbr.serve.budgets``): the
card reading (``card_reading``: ``cudaMemGetInfo`` and the allocator's
statistics), the mesh's all-gather of the readings, ``derive_budgets``. A
mean over the window's units, so that the reading's rare long stalls
count. ``None`` where the program records no such span."""

from gpubench import spans


def read(r, name):
    units = r.get("units") or 0
    s = spans.host_s(r["window"], ("serve.budgets",))
    if not units or s is None:
        return None
    return 1e3 * s / units
