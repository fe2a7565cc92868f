"""The streamed top-k's selection of the top groups, on the card, at the
serve-batch cell's own group maxima.

Builds ``lstm32-items50m`` with the benchmark's weights, serves one batch
of the cell's traffic and keeps the group maxima ``gmax [G, U]`` that K4
gave the single pass (``_submax_winners``' argument). Then:

* checks ``models/base.py _top_groups`` against one ``torch.topk(gmax, w,
  dim=0)`` for ``w = kk`` and ``kk + 1``: the same group set for every
  user, and the ``w``-th value equal bit for bit;
* times both by CUDA events, the two-level selection at several
  super-group widths, its steps one by one (the super-group maxima down
  their columns or transposed first) and both at 1 to 128 users;
* lists the kernels of one call of each under ``torch.profiler``.

Run from the repository's root on a card::

    python3 scripts/group_select_probe.py [--seed N] [--reps R]

Writes ``chiprun_out/group_select_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import gen, program, spec, weights  # noqa: E402
from sbr_rs_tpu_torch.models import base  # noqa: E402

CELL = "lstm32-items50m.serve-batch"


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def event_ms(fn, reps: int, warm: int = 1) -> list:
    """Device ms of each of ``reps`` calls of ``fn``, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def kernels(fn) -> list:
    """``(kernel, device ms)`` of one call of ``fn`` under the profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key[:90], e.self_device_time_total / 1e3) for e in prof.key_averages()]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:12]


def same_selection(gmax: torch.Tensor, w: int) -> dict:
    """The two-level selection against one ``torch.topk`` down the columns."""
    rv, ri = torch.topk(gmax, w, dim=0)
    v, i = base._top_groups(gmax, w)
    sets = torch.equal(ri.T.sort(dim=1).values, i.sort(dim=1).values)
    rows_differ = int((ri.T.sort(dim=1).values != i.sort(dim=1).values).any(dim=1).sum())
    return {
        "w": w,
        "same_group_sets": bool(sets),
        "users_whose_set_differs": rows_differ,
        "values_equal": bool(torch.equal(rv.T, v)),
        "wth_value_bit_equal": bool(torch.equal(rv[-1].view(torch.int32), v[:, -1].contiguous().view(torch.int32))),
    }


def steps(gmax: torch.Tensor, w: int, sg: int, reps: int) -> dict:
    """Device ms of each step of the two-level selection at width ``sg``."""
    g, u = gmax.shape
    blocks = g // sg
    whole = blocks * sg
    grouped = gmax[:whole].view(blocks, sg, u)
    smax = grouped.amax(dim=1)
    _, si = torch.topk(smax, w, dim=0)
    si = si.T
    users = torch.arange(u, device=gmax.device)[:, None]
    cand = torch.cat([grouped[si, :, users].reshape(u, w * sg), gmax[whole:].T], dim=1)
    med = lambda xs: float(np.median(xs))  # noqa: E731
    return {
        "amax_ms": med(event_ms(lambda: grouped.amax(dim=1), reps)),
        "super_topk_dim0_ms": med(event_ms(lambda: torch.topk(smax, w, dim=0), reps)),
        "super_topk_transposed_ms": med(event_ms(lambda: torch.topk(smax.T.contiguous(), w, dim=1), reps)),
        "gather_ms": med(event_ms(lambda: grouped[si, :, users], reps)),
        "cat_ms": med(event_ms(lambda: torch.cat([grouped[si, :, users].reshape(u, w * sg), gmax[whole:].T], 1), reps)),
        "final_topk_ms": med(event_ms(lambda: torch.topk(cand, w, dim=1), reps)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card: this probe measures on a card only", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out = {"card": card(), "device": torch.cuda.get_device_name(0), "torch": torch.__version__, "seed": args.seed}
    print(out, flush=True)
    cell = spec.load_workload(CELL)
    cfg = spec.load_config(spec.load_benchmark(), cell["config"])
    p = cell["traffic"]
    model = program.build(cfg, args.seed, cell["weights"], "cuda")
    rng = np.random.default_rng(weights.derived_seed(args.seed, 10))
    hist = gen.histories(rng, int(p["users_per_batch"]), cfg["num_items"], *p["history_lengths"], p["zipf_exponent"])
    kept = {}
    orig = base._submax_winners

    def spy(allsub, gmax, kk, r):
        kept.update(gmax=gmax, kk=kk)
        return orig(allsub, gmax, kk, r)

    base._submax_winners = spy
    try:
        model.recommend_batch(hist, k=int(p["k"]), exclude_seen=True, return_scores=True)
    finally:
        base._submax_winners = orig
    torch.cuda.synchronize()
    gmax, kk = kept["gmax"], kept["kk"]
    del model
    torch.cuda.empty_cache()
    out.update(gmax_shape=list(gmax.shape), kk=kk, route=repr(base.topk_streamed.last_route[0]),
               setup_s=round(time.perf_counter() - t0, 3))
    print(f"gmax {tuple(gmax.shape)} kk {kk} route {out['route']}", flush=True)

    out["checks"] = [same_selection(gmax, w) for w in (kk, kk + 1)]
    print("checks", out["checks"], flush=True)

    med = lambda xs: float(np.median(xs))  # noqa: E731
    ref = event_ms(lambda: torch.topk(gmax, kk, dim=0), 3)
    out["one_level_ms"] = ref
    widths = {}
    for sg in (32, 64, 128, 256, 512):
        base.SUPER_GROUP = sg
        widths[sg] = event_ms(lambda: base._top_groups(gmax, kk), args.reps)
    base.SUPER_GROUP = 128
    out["two_level_ms_by_width"] = {str(k): v for k, v in widths.items()}
    out["two_level_median_ms_by_width"] = {str(k): med(v) for k, v in widths.items()}
    print("one level", [round(x, 3) for x in ref], "two levels", out["two_level_median_ms_by_width"], flush=True)
    out["steps_128"] = steps(gmax, kk, 128, args.reps)
    out["steps_64"] = steps(gmax, kk, 64, args.reps)
    print("steps", out["steps_128"], out["steps_64"], flush=True)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base._top_groups(gmax, kk)
    torch.cuda.synchronize()
    out["two_level_extra_peak_bytes"] = torch.cuda.max_memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    torch.topk(gmax, kk, dim=0)
    torch.cuda.synchronize()
    out["one_level_extra_peak_bytes"] = torch.cuda.max_memory_allocated() - before

    out["kernels_one_level"] = kernels(lambda: torch.topk(gmax, kk, dim=0))
    out["kernels_two_level"] = kernels(lambda: base._top_groups(gmax, kk))

    # Fewer users: both levels' times beside one select's, the floor on the
    # maxima lifted so that the two-level route runs at every width.
    floor = base.TWO_LEVEL_MIN_MAXIMA
    base.TWO_LEVEL_MIN_MAXIMA = 0
    for uu in (1, 8, 16, 32, 64, 128):
        g1 = gmax[:, :uu].contiguous()
        one = event_ms(lambda: torch.topk(g1, kk, dim=0), args.reps)
        two = event_ms(lambda: base._top_groups(g1, kk), args.reps)
        out[f"u{uu}"] = {"one_level_ms": med(one), "two_level_ms": med(two), "check": same_selection(g1, kk)}
        print(f"U={uu}", out[f"u{uu}"], flush=True)
    base.TWO_LEVEL_MIN_MAXIMA = floor

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/group_select_probe.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "gmax_shape", "kk", "checks", "two_level_median_ms_by_width")}))
    ok = all(c["same_group_sets"] and c["wth_value_bit_equal"] for c in out["checks"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
