"""The program's own spans in a traced window: the ranges that
``sbr_rs_tpu_torch.utils.metrics.span`` records as ``sbr.<name>`` on the
host (``Window.host``), and the kernels launched inside them, matched
launch to kernel by correlation id (``Window.launches``, ``Window.device``).
A program without a span of a name gives nothing to read."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

PREFIX = "sbr."


def intervals(window, name: str) -> List[Tuple[int, int]]:
    """``(start, end)`` ns of every span ``sbr.<name>`` (of any thread),
    clipped to the window, sorted, overlaps merged."""
    full = PREFIX + name
    out: List[List[int]] = []
    for s, e, n, _ in window.host:  # sorted by start
        if n != full:
            continue
        s, e = max(s, window.t0), min(e, window.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def host_s(window, names: Iterable[str]) -> Optional[float]:
    """Seconds of the window inside spans of ``names``; ``None`` where no
    span of any of them is there."""
    found = [iv for name in names for iv in intervals(window, name)]
    if not found:
        return None
    return sum(e - s for s, e in found) / 1e9


def kernels_in(window, name: str) -> List[Tuple[str, float]]:
    """``(kernel, seconds inside the window)`` of every kernel whose launch
    began on the host inside a span ``sbr.<name>`` (or a span nested in
    one)."""
    spans = intervals(window, name)
    starts = [s for s, _ in spans]
    inside = set()
    for t, corr in window.launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            inside.add(corr)
    return [
        (n, (min(e, window.t1) - max(s, window.t0)) / 1e9)
        for s, e, kind, n, corr in window.device
        if kind == "kernel" and corr in inside
    ]
