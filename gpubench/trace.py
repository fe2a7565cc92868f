"""The traced run: a ``torch.profiler`` session (host operators, the
benchmark's own spans, CUDA runtime calls, device kernels, copies and
sets) opened before a few warm-up units, so that a dropped first record
belongs to them, and read over the measured window only.

A trace is trusted only when it lost nothing in the window: every kernel
launch the runtime recorded has its device record (matched by correlation
id), and each hand-written kernel's count equals its wrapper's ``.launches``
counter over the same window (``kernels/*.json`` map kernel symbols to
counters). Otherwise the window is measured again (``cell.TRACE_ATTEMPTS``
tries in all), then the run fails naming the kernel and both counts.

A user annotation's copy on the device's timeline (``record_function``
makes one, whoever calls it) is not a device operation: it is skipped and
counted in ``Window.span_copies``, whatever its name."""

from __future__ import annotations

import collections
import contextlib
import re
from typing import Dict, List, Tuple

from . import spec

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = re.compile(r"(?i)launchkernel|launchcooperativekernel")
SPAN_PREFIX = "bench:"


class TraceLost(RuntimeError):
    """The trace lacks device records of launches made in the window."""


def span(name: str):
    """A span of the benchmark's own around its calls into the program,
    recorded in the trace (and free when no profiler runs)."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def session(cuda: bool = True):
    """A profiler session of host and (with ``cuda``) device activity;
    yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def short_name(name: str, width: int = 90) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::`` and its
    parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


def activity(e) -> str:
    """The kineto activity of a profiler event: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``gpu_user_annotation`` (a user annotation's copy on the
    device's timeline), ``cuda_runtime`` (a launch call),
    ``user_annotation`` or ``cpu_op`` (torch builds without
    ``activity_type`` are read by the device and the name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if _LAUNCH.search(name):
        return "cuda_runtime"
    return "user_annotation" if e.is_user_annotation() else "cpu_op"


class Window:
    """The events of one measured window ``[t0_ns, t1_ns]`` of a session."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        self.device: List[Tuple[int, int, str, str, int]] = []  # start, end, kind, name, correlation
        self.launches: List[Tuple[int, int]] = []  # start, correlation
        self.host: List[Tuple[int, int, str, int]] = []  # start, end, name, thread (operators, spans)
        self.span_copies: Dict[str, int] = collections.Counter()  # in the window, by name
        events = [(e, activity(e)) for e in prof.profiler.kineto_results.events()]
        # A device record that bears a host annotation's name is its copy,
        # also where the profiler does not mark it as one.
        annotations = {e.name() for e, kind in events if kind == "user_annotation"}
        for e, kind in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind == "gpu_user_annotation" or (kind in DEVICE_KINDS and e.name() in annotations):
                if end > t0_ns and start < t1_ns:
                    self.span_copies[e.name()] += 1
                continue
            if kind in DEVICE_KINDS:
                if end > t0_ns and start < t1_ns:
                    self.device.append((start, end, kind, e.name(), e.correlation_id()))
                continue
            if kind == "cuda_runtime" and t0_ns <= start < t1_ns and _LAUNCH.search(e.name()):
                self.launches.append((start, e.correlation_id()))
            if kind in ("cpu_op", "user_annotation", "cuda_runtime"):
                if end > t0_ns and start < t1_ns:
                    self.host.append((start, end, e.name(), e.start_thread_id()))
        self.device.sort()
        self.host.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self) -> List[Tuple[str, float]]:
        """``(name, seconds inside the window)`` of every kernel."""
        return [
            (name, (min(e, self.t1) - max(s, self.t0)) / 1e9)
            for s, e, kind, name, _ in self.device
            if kind == "kernel"
        ]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations, clipped to the window."""
        out: List[List[int]] = []
        for s, e, *_ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def check(self, counters: Dict[str, int]) -> List[str]:
        """Raise :class:`TraceLost` where the window lost device records;
        return notes on kernels whose counter has no symbol in the trace."""
        kernel_corr = {c for _, _, kind, _, c in self.device if kind == "kernel"}
        missing = [t for t, c in self.launches if c not in kernel_corr]
        if missing:
            at = sorted((t - self.t0) / 1e9 for t in missing)
            raise TraceLost(
                f"{len(missing)} of {len(self.launches)} kernel launches in the window have no device record "
                f"(launched {at[0]:.6f}-{at[-1]:.6f} s into the window)"
            )
        groups = spec.kernel_map()
        names = collections.Counter(short_name(n) for n, _ in self.kernels())
        notes = []
        for symbol, wrappers in groups.items():
            counted = sum(counters.get(w, 0) for w in wrappers)
            traced = sum(v for n, v in names.items() if re.search(symbol, n))
            if counted and not traced:
                notes.append(f"{symbol}: {counted} launches counted, none traced under that name")
            elif traced != counted:
                raise TraceLost(f"{symbol}: {traced} device records in the window, {counted} launches counted ({'+'.join(wrappers)})")
        return notes

    def breakdown(self) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle time by
        what the host was doing (the benchmark's span and the innermost host
        operator under way halfway through each idle gap)."""
        ops = collections.Counter()
        for name, sec in self.kernels():
            ops[short_name(name, 60)] += sec
        for s, e, kind, name, _ in self.device:
            if kind != "kernel":
                ops[kind] += (min(e, self.t1) - max(s, self.t0)) / 1e9
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        idle = collections.Counter()
        for (s, e), label in zip(gaps, self._doing([(a + b) // 2 for a, b in gaps])):
            idle[label] += (e - s) / 1e9
        top = lambda c: [[k, v] for k, v in c.most_common(10)]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}

    def _doing(self, times: List[int]) -> List[str]:
        """``span/operator`` under way on the host at each of the sorted
        ``times``: the benchmark's innermost span and the innermost host
        operator (of any thread) then, by a sweep over per-thread stacks."""
        stacks: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(list)
        out, i = [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                s, e, name, tid = self.host[i]
                stack = stacks[tid]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, e, name))
                i += 1
            span_name, op, op_start = "-", "-", -1
            for stack in stacks.values():
                while stack and stack[-1][1] < t:
                    stack.pop()
                live = [x for x in stack if x[1] >= t]
                spans = [x for x in live if x[2].startswith(SPAN_PREFIX)]
                ops = [x for x in live if not x[2].startswith(SPAN_PREFIX)]
                if spans:
                    span_name = spans[-1][2][len(SPAN_PREFIX):]
                if ops and ops[-1][0] > op_start:
                    op, op_start = ops[-1][2], ops[-1][0]
            out.append(f"{span_name}/{op}")
        return out
