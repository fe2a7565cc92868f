#!/usr/bin/env python3
"""Does ``utils.metrics.trace`` keep a region's first kernels late in a long
process? On one CUDA card, from the root of a checkout:

    python3 scripts/torch_trace_probe.py

Traces one serving batch (LSTM-127 Normal over 1,000,000 items, 512 users:
K1, then the 3xTF32 K4, then PyTorch's top-k) three times: in this process
before anything else, in this process after ``chip_smoke.main()`` has run
every phase (with its many profiler sessions), and in a fresh process after
that. Each probe prints how many kernels its trace holds, whether K1 and K4
are among them, and how long after the region's first operator the first
kernel starts; the last line is one JSON object of the three. ``chip_smoke``
traces its phase 16 in a process of its own because of what this shows.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_ITEMS, USERS = 1_000_000, 512
SYMBOLS = ("lstm_fwd_smem_kernel", "score_submax_kernel")


def probe(label):
    """One warm-up batch, then one traced batch; what the trace holds."""
    import torch

    import chip_smoke
    from sbr_rs_tpu_torch.utils.metrics import trace

    model = chip_smoke.serving_model(NUM_ITEMS, torch.device("cuda", 0), seed=3)
    histories = chip_smoke.serving_histories(NUM_ITEMS, users=USERS, seed=3)
    model.recommend_batch(histories, k=10)
    log_dir = tempfile.mkdtemp(prefix="sbr_trace_probe_")
    with trace(log_dir):
        model.recommend_batch(histories, k=10)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in events if e.get("cat") == "cpu_op")
    out = {
        "probe": label,
        "kernels": len(kernels),
        "named": [s for s in SYMBOLS if any(s in e["name"] for e in kernels)],
        "first_kernel_ms": (min(e["ts"] for e in kernels) - start) / 1e3 if kernels else None,
    }
    print(f"probe {label}: {out}", flush=True)
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke

    results = [probe("fresh, in this process")]
    chip_smoke.main()
    results.append(probe("after chip_smoke.main(), in this process"))
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); from scripts.torch_trace_probe import probe; "
            "print(json.dumps(probe('fresh process')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"the fresh process failed: {proc.stderr[-2000:]}")
    print(proc.stdout.splitlines()[-2], flush=True)
    results.append(json.loads(proc.stdout.splitlines()[-1]))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
