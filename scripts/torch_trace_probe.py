#!/usr/bin/env python3
"""Does ``utils.metrics.trace`` keep a region's first kernels late in a long
process? On one CUDA card, from the root of a checkout:

    python3 scripts/torch_trace_probe.py
    python3 scripts/torch_trace_probe.py --age [BUSY_SECONDS]

The region is one serving batch (LSTM-127 Normal over 1,000,000 items, 512
users: K1, then the 3xTF32 K4, then PyTorch's top-k).

With no argument it traces the region three times: in this process before
anything else, in this process after ``chip_smoke.main()`` has run every
phase (with its many profiler sessions), and in a fresh process after that.
Each probe prints how many kernels its trace holds, whether K1 and K4 are
among them, how long after the region's first operator the first kernel
starts, and the least and the median time from a kernel's launch call to
its start (a negative one: the kernels' clock runs apart from the host's);
the last line is one JSON object of the three. It exits non-zero unless the
three traces hold the same kernels, K1 and K4 among them: the check that
keeps ``trace`` from losing a region's first kernels again.

``--age`` reproduces the fault in minutes instead. A process traces the
region fresh, after 300 short profiler sessions (5 matmuls each), and after
BUSY_SECONDS (default 90) of back-to-back 4096 x 4096 matmuls without the
profiler; at that point it also traces the region under torch's profiler
set up three other ways: a warm-up step through a ``schedule``, a 50 ms
wait inside the profiler before the region, and a 5 ms sleep kernel
launched inside the profiler before the region. Three more processes repeat
the fresh and the busy traces: with ``TEARDOWN_CUPTI=0``; with 30 s of idle
time between the busy period and the trace; with 12 short profiler sessions
of 10 small kernels each between them (each session's kernels counted
through ``prof.events()``). The last line is one JSON object of all of
them; it reports and checks nothing.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_ITEMS, USERS = 1_000_000, 512
SYMBOLS = ("lstm_fwd_smem_kernel", "score_submax_kernel")
SESSIONS = 300
# ``--age``: the processes after the first, their environment, and what
# runs between the busy period and the trace.
AFTERMATHS = {"TEARDOWN_CUPTI=0": ({"TEARDOWN_CUPTI": "0"}, None), "idle 30 s": ({}, "idle"),
              "12 short sessions": ({}, "sessions")}


def serving():
    """The region's model and histories, after one warm-up batch."""
    import torch

    import chip_smoke

    model = chip_smoke.serving_model(NUM_ITEMS, torch.device("cuda", 0), seed=3)
    histories = chip_smoke.serving_histories(NUM_ITEMS, users=USERS, seed=3)
    model.recommend_batch(histories, k=10)
    return model, histories


@contextlib.contextmanager
def _profiled(log_dir, how):
    """``trace``, or torch's profiler set up another way (``--age``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    from sbr_rs_tpu_torch.utils.metrics import trace

    if how == "trace":
        with trace(log_dir):
            yield
        return
    torch.cuda.synchronize()
    kw = {"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)} if how == "warm-up step" else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(log_dir), **kw) as prof:
        if how == "warm-up step":
            prof.step()
        elif how == "50 ms wait":
            time.sleep(0.05)
        elif how == "5 ms sleep kernel":
            torch.cuda._sleep(int(5e-3 * 1.98e9))  # cycles at the H100's 1.98 GHz boost clock
        yield
        torch.cuda.synchronize()


def probe(label, state=None, how="trace"):
    """One traced batch (after a warm-up one when ``state`` is None); what
    the trace holds."""
    model, histories = state or serving()
    log_dir = tempfile.mkdtemp(prefix="sbr_trace_probe_")
    with _profiled(log_dir, how):
        model.recommend_batch(histories, k=10)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in events if e.get("cat") == "cpu_op")
    launched = {
        e["args"]["correlation"]: e["ts"] for e in events
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
    }
    lag = [e["ts"] - launched[e["args"]["correlation"]] for e in kernels
           if e.get("args", {}).get("correlation") in launched]
    out = {
        "probe": label,
        "how": how,
        "kernels": len(kernels),
        "kernel_names": sorted(e["name"][:80] for e in kernels),
        "named": [s for s in SYMBOLS if any(s in e["name"] for e in kernels)],
        "first_kernel_ms": (min(e["ts"] for e in kernels) - start) / 1e3 if kernels else None,
        "launch_to_kernel_us": [min(lag), statistics.median(lag)] if lag else None,
    }
    print(f"probe {label}: { {k: v for k, v in out.items() if k != 'kernel_names'} }", flush=True)
    return out


def _busy(seconds):
    import torch

    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(50):
            x = (x @ x).clamp_(-1, 1)
        torch.cuda.synchronize()


def _short_session(kernels):
    """One profiler session of ``kernels`` small kernels: how many it
    recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(kernels):
            x.add_(1)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def age(busy_s: float, aftermath=None) -> list:
    """``--age``: the first process's sequence (``aftermath`` None), or a
    later process's: fresh, busy, ``aftermath`` (``"idle"``, ``"sessions"``
    or ``"plain"``: nothing), one trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = serving()
    out = [probe("fresh", state)]
    first = aftermath is None
    if first:
        x = torch.randn(2048, 2048, device="cuda")
        for _ in range(SESSIONS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    x @ x
                torch.cuda.synchronize()
            prof.key_averages()
        out.append(probe(f"after {SESSIONS} profiler sessions", state))
    _busy(busy_s)
    label = f"after {busy_s:g} s of matmuls"
    if aftermath == "idle":
        time.sleep(30)
        label += ", then 30 s idle"
    elif aftermath == "sessions":
        recorded = [_short_session(10) for _ in range(12)]
        print(f"short sessions: kernels recorded of 10 each: {recorded}", flush=True)
        label += ", then 12 short sessions"
    hows = ["trace", "warm-up step", "50 ms wait", "5 ms sleep kernel", "trace"] if first else ["trace"]
    return out + [probe(label, state, how) for how in hows]


def _in_fresh_process(call, env=None, timeout=600):
    """``call`` (an expression over this module) in a fresh process: its
    printed lines, then its JSON result."""
    code = f"import json, sys; sys.path.insert(0, {ROOT!r}); from scripts import torch_trace_probe as p; " \
           f"print(json.dumps(p.{call}))"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env=None if env is None else {**os.environ, **env})
    if proc.returncode != 0:
        sys.exit(f"the fresh process failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    return lines[:-1], json.loads(lines[-1])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_trace_probe: no CUDA device")
    if sys.argv[1:2] == ["--age"]:
        busy_s = float(sys.argv[2]) if len(sys.argv) > 2 else 90.0
        results = {"default": age(busy_s)}
        for name, (env, aftermath) in AFTERMATHS.items():
            lines, results[name] = _in_fresh_process(f"age({busy_s}, {aftermath or 'plain'!r})", env, 900)
            for line in lines:
                print(f"{name}: {line}", flush=True)
        print(json.dumps({k: [{f: v for f, v in r.items() if f != "kernel_names"} for r in rs]
                          for k, rs in results.items()}))
        return
    import chip_smoke

    results = [probe("fresh, in this process")]
    chip_smoke.main()
    results.append(probe("after chip_smoke.main(), in this process"))
    lines, fresh = _in_fresh_process("probe('fresh process')")
    print(lines[-1], flush=True)
    results.append(fresh)
    print(json.dumps([{k: v for k, v in r.items() if k != "kernel_names"} for r in results]))
    lost = [r["probe"] for r in results if r["named"] != list(SYMBOLS) or r["kernel_names"] != results[0]["kernel_names"]]
    if lost:
        sys.exit(f"torch_trace_probe: the traces of {lost} lack kernels the first trace holds (K1 and K4 among them)")


if __name__ == "__main__":
    main()
