"""The pipelined small route on the card, at the HSTU cell's traffic.

Builds ``hstu-ml20m-large`` with the benchmark's weights and draws batches
of its traffic (``gpubench/traffic/serve_batch_timed.draw``: 8,192 timed
histories a batch, each an int64 array of ids and one of times). Then, on
each of ``--seeds`` seeds:

* serves each batch at 1, 2, 4 and 8 sub-batches
  (``models/base.py PIPELINE_MIN_USERS`` set to ``U // P``), in turns,
  and times each call by the host's clock (a call ends with its lists on
  the host); the lists of every count are held to the one-batch call's
  (ids equal, scores within 1e-6);
* times the host's stages of one batch alone: ``_flatten``,
  ``_flatten_times``, ``_seen`` and the lists' ``tolist``;
* under ``torch.profiler``, one call at each count: the device's busy
  share of the call, and the host's waits (``cudaEventSynchronize``,
  ``cudaStreamSynchronize``) and ``aten::nonzero`` calls, in the call and
  inside ``sbr.serve.topk``;
* the peak device memory of one call at each count, and the sub-batches
  ``recommend_batch.pipelined_subbatches`` counts in one call at the
  program's own constant.

Run from the repository's root on a card::

    python3 scripts/serve_pipeline_probe.py [--seeds 3] [--reps 6]

Writes ``chiprun_out/serve_pipeline_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import program, spec, weights  # noqa: E402
from gpubench.traffic import serve_batch_timed  # noqa: E402
from sbr_rs_tpu_torch.models import base  # noqa: E402
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel  # noqa: E402

CELL = "hstu-ml20m-large.serve-batch"
COUNTS = (1, 2, 4, 8)
WAITS = ("cudaEventSynchronize", "cudaStreamSynchronize", "aten::nonzero")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def host_ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` calls of ``fn`` (after one warm call)."""
    fn()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def inside(e, name: str) -> bool:
    p = e.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p is not None


def profiled(serve) -> dict:
    """One call of ``serve`` under the profiler: the device's busy share of
    its wall time and the host's waits, in the call and inside
    ``sbr.serve.topk``."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    calls = [e for e in events if e.name == "sbr.recommend_batch"]
    out = {"wall_ms": 1e3 * wall}
    if calls:
        c0, c1 = calls[0].time_range.start, calls[0].time_range.end
        busy = union_s((max(s, c0), min(e, c1)) for s, e in dev if e > c0 and s < c1)
        out["call_ms"] = (c1 - c0) / 1e3
        out["device_busy_share"] = busy / (c1 - c0) if c1 > c0 else None
    for w in WAITS:
        out[w] = sum(e.name == w for e in events)
        out[w + "_in_topk"] = sum(e.name == w and inside(e, "sbr.serve.topk") for e in events)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3141592653)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card: this probe measures on a card only", file=sys.stderr)
        return 1
    out = {"card": card(), "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "program_min_users": base.PIPELINE_MIN_USERS, "seeds": {}}
    print({k: out[k] for k in ("card", "device", "torch", "program_min_users")}, flush=True)
    cell = spec.load_workload(CELL)
    cfg = spec.load_config(spec.load_benchmark(), cell["config"])
    p = cell["traffic"]
    u, k = int(p["users_per_batch"]), int(p["k"])
    own = base.PIPELINE_MIN_USERS
    ok = True
    for s in range(args.seeds):
        seed = args.first_seed + 7919 * s
        t0 = time.perf_counter()
        model = program.build(cfg, seed, cell["weights"], "cuda")
        rng = np.random.default_rng(weights.derived_seed(seed, 30))
        batches = []
        for _ in range(args.batches):
            ids, times, lens = serve_batch_timed.draw(rng, u, cfg["num_items"], p)
            cuts = np.cumsum(lens)[:-1]
            batches.append((np.split(ids, cuts), np.split(times, cuts)))

        def serve(b, parts):
            base.PIPELINE_MIN_USERS = u // parts
            hist, times = batches[b]
            return model.recommend_batch(hist, k=k, exclude_seen=True, return_scores=True, timestamps=times)

        row = {"setup_s": time.perf_counter() - t0}
        # Warm every shape, and hold every count's lists to one batch's.
        agree = {}
        for b in range(args.batches):
            want = serve(b, 1)
            for parts in COUNTS[1:]:
                got = serve(b, parts)
                diff = sum(g != w for g, w in zip(got[0], want[0]))
                err = float(np.abs(got[1] - want[1]).max())
                agree.setdefault(parts, []).append({"users_whose_list_differs": diff, "max_score_diff": err})
                ok &= diff == 0 and err <= 1e-6
        row["agreement"] = {str(c): v for c, v in agree.items()}
        torch.cuda.synchronize()
        times_ms = {c: [] for c in COUNTS}
        for r in range(args.reps):
            order = COUNTS if r % 2 == 0 else COUNTS[::-1]
            for b in range(args.batches):
                for parts in order:
                    t = time.perf_counter()
                    serve(b, parts)
                    times_ms[parts].append(1e3 * (time.perf_counter() - t))
        row["batch_ms"] = {str(c): v for c, v in times_ms.items()}
        row["batch_ms_median"] = {str(c): statistics.median(v) for c, v in times_ms.items()}
        row["users_per_s_median"] = {str(c): u / (statistics.median(v) / 1e3) for c, v in times_ms.items()}
        print(f"seed {seed}: ms a batch by sub-batches {row['batch_ms_median']}", flush=True)

        hist, times = batches[0]
        flat, lens = base._flatten(hist)
        want_ids = np.asarray(serve(0, 1)[0], dtype=np.int64)
        row["host_ms"] = {
            "_flatten": host_ms(lambda: base._flatten(hist), args.reps),
            "_flatten_times": host_ms(lambda: base._flatten_times(times, lens), args.reps),
            "_seen": host_ms(lambda: base._seen(flat, lens, cfg["num_items"], True), args.reps),
            "tolist": host_ms(lambda: want_ids.tolist(), args.reps),
        }
        print(f"  host ms {row['host_ms']}", flush=True)
        row["profiled"] = {}
        row["peak_bytes"] = {}
        for parts in COUNTS:
            serve(0, parts)
            row["profiled"][str(parts)] = profiled(lambda: serve(0, parts))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            serve(0, parts)
            torch.cuda.synchronize()
            row["peak_bytes"][str(parts)] = int(torch.cuda.max_memory_allocated())
        print(f"  profiled {row['profiled']}", flush=True)
        print(f"  peak bytes {row['peak_bytes']}", flush=True)
        base.PIPELINE_MIN_USERS = own
        before = ImplicitSequenceModel.recommend_batch.pipelined_subbatches
        model.recommend_batch(hist, k=k, exclude_seen=True, return_scores=True, timestamps=times)
        row["program_subbatches_a_batch"] = ImplicitSequenceModel.recommend_batch.pipelined_subbatches - before
        print(f"  the program's constant {own}: {row['program_subbatches_a_batch']} sub-batches a batch", flush=True)
        out["seeds"][str(seed)] = row
        del model, batches
        torch.cuda.empty_cache()
    base.PIPELINE_MIN_USERS = own
    med = {str(c): statistics.median(r["batch_ms_median"][str(c)] for r in out["seeds"].values()) for c in COUNTS}
    out["batch_ms_median_over_seeds"] = med
    out["lists_agree"] = ok
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/serve_pipeline_probe.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": out["card"], "batch_ms_median_over_seeds": med, "lists_agree": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
