"""One cell's run: set-up, warm-up, the measured window, the readings, and
the check that decides ``correct``. ``run.py`` drives it on the card; the
CPU tests drive it at toy sizes with ``device="cpu"``.

A traffic kind's ``Traffic(ctx)`` builds the model and the traffic in its
constructor and provides:

* ``warm()``: the set-up's warm-up (every shape the window uses);
* ``step()``: one unit of work of the closed loop (a batch, a request),
  its results on the host when it returns;
* ``open_window()``: forget what the warm-up recorded;
* ``work()``: ``{"attempted", "failed", "units", ...}`` of the window;
* ``end_to_end(window_s)``: the cell's end-to-end metrics;
* ``reading()``: what the per-layer metric readers need besides the trace
  (``flops``, ``units``, ``users``...);
* ``release()``: drop every device tensor of the program;
* ``checks()``: ``{name: value}`` of the numbers compared with the
  workload's limits, computed by the plain reference."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, Optional

from . import spec
from .trace import TraceLost

FORBIDDEN = ("jax", "jaxlib", "flax", "sbr_rs_tpu")
# A traced run: seconds of the cell's work inside the profiler session
# before its window, and windows tried before a trace that keeps losing
# records fails the run.
TRACED_WARM_S = 2.0
TRACE_ATTEMPTS = 3


@dataclasses.dataclass
class Context:
    cfg: Dict
    cell: Dict
    seed: int
    device: str
    fault: Optional[str] = None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot compared whole: ``sbr_rs_tpu_torch`` is
    the port, not ``sbr_rs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        cfg: Optional[Dict] = None, cell: Optional[Dict] = None, fault: Optional[str] = None,
        log=print) -> Dict:
    """Run cell ``name`` (its files, or the ``cfg``/``cell`` dicts given)
    and return the result object; ``t_start`` is the process start on
    ``time.perf_counter``'s clock."""
    import torch

    bench = spec.load_benchmark()
    if cell is None:
        cell = spec.load_workload(name)
    if cfg is None:
        cfg = spec.load_config(bench, cell["config"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ctx = Context(cfg=cfg, cell=cell, seed=int(seed), device=device, fault=fault)
    phases = {"imports": time.perf_counter() - t_start}
    traffic = spec.traffic_module(cell["kind"]).Traffic(ctx)
    sync()
    phases["model_and_traffic"] = time.perf_counter() - t_start - sum(phases.values())
    traffic.warm()
    sync()
    phases["warm_up"] = time.perf_counter() - t_start - sum(phases.values())
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f} phases " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    # The window: the harness's own objects frozen out of the collector's
    # scans, so that its pauses are the program's alone; the memory peak
    # is the window's own, not set-up's (whose table draws it replaced).
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pauses = _GcPauses()
    gc.callbacks.append(pauses)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        try:
            window_s, counters, window = _window(traffic, seconds, trace, cuda, sync)
            break
        except TraceLost as e:  # measured again: no share from a trace that lost records
            log(f"trace attempt {attempt}: {e}")
            if attempt == TRACE_ATTEMPTS:
                raise
    gc.callbacks.remove(pauses)
    gc.unfreeze()
    work = traffic.work()
    log(f"window_s {window_s:.6f} work {work} counters {counters}")
    log(f"gc pauses by generation (count, total s, longest s) {pauses.summary()}")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    result = {"correct": None, "attempted": int(work["attempted"]), "failed": int(work["failed"])}
    if trace:
        reading = dict(traffic.reading(), window_s=window_s, counters=counters, window=window,
                       cfg=cfg, cell=cell)
        metrics = {}
        for m in spec.per_layer_for(bench, name):
            value = spec.metric_module(m["name"]).read(reading, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = traffic.end_to_end(window_s)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end_for(bench, name)}
    result["metrics"] = metrics
    result["device"] = device_info(cuda, int(cell.get("chips", 1)), peak)
    if trace:
        result["device"]["busy_s"] = window.busy_s()
        result["device"]["window_s"] = window.window_s
        result["breakdown"] = window.breakdown()
    # The reference runs once the program's state is gone.
    traffic.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = traffic.checks()
    limits = cell["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items()}
    correct = work["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = bool(correct)
    result["checks"] = checks
    log(f"check_s {time.perf_counter() - t_check:.3f}")
    return result


class _GcPauses:
    """The collector's pauses in the window, by generation (a ``gc``
    callback: ``start`` and ``stop`` of each collection)."""

    def __init__(self):
        self.t = 0.0
        self.by_gen = {}

    def __call__(self, phase, info):
        if phase == "start":
            self.t = time.perf_counter()
            return
        n, total, longest = self.by_gen.get(info["generation"], (0, 0.0, 0.0))
        d = time.perf_counter() - self.t
        self.by_gen[info["generation"]] = (n + 1, total + d, max(longest, d))

    def summary(self):
        return {g: (n, round(t, 6), round(m, 6)) for g, (n, t, m) in sorted(self.by_gen.items())}


def _window(traffic, seconds: float, trace: bool, cuda: bool, sync):
    """One measured window: ``(window_s, counters, Window or None)``. A
    traced window opens its profiler session ``TRACED_WARM_S`` before, on
    units of the cell's own work, so that the records a session can lose at
    its start belong to them."""
    from . import program
    from .trace import Window, session, span

    prof_cm = session(cuda) if trace else None
    prof = prof_cm.__enter__() if trace else None
    try:
        if trace:
            t = time.perf_counter()
            while True:
                with span("warm"):
                    traffic.step()
                if time.perf_counter() - t >= TRACED_WARM_S:
                    break
            sync()
        traffic.open_window()
        before = program.counters()
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        while True:
            with span(traffic.span_name):
                traffic.step()
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
        after = program.counters()
    finally:
        if trace:
            prof_cm.__exit__(None, None, None)
    counters = {k: after[k] - before.get(k, 0) for k in after}
    window = None
    if trace:
        window = Window(prof, t0_ns, t1_ns)
        print(f"trace: annotation copies on the device's timeline, skipped: {dict(window.span_copies)}", flush=True)
        for note in window.check(counters):
            print("trace: " + note, flush=True)
    return window_s, counters, window


def device_info(cuda: bool, count: int, peak: int) -> Dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count, "memory_peak_bytes": peak}
