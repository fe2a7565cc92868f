#!/usr/bin/env python3
"""Times one checkout of the port in the cells of ``chip_smoke.py``, for A/B
runs of two trees in turns on one card. The cells come from
``chip_smoke.py``'s own functions (this checkout's), applied to the
``sbr_rs_tpu_torch`` of ``--tree``:

* ``serve-10M`` (phase 4) and ``serve-50M-merge`` (phase 5d):
  ``recommend_batch(k=10)`` for 4096 users over 10,000,000 and 50,000,000
  items: users/s, the median of 3 batches after one warm-up;
* ``eval-10M-4096`` (phase 6b): ``mrr_score`` of the serve-10M model: µs per
  user, the median of 3 calls after one warm-up;
* ``p3`` (phase 3): WARP's candidate scores at fit-bench's shape (8192
  positions x 5 of a 1682 x 33 f32 table), P3 (``cand_score_smem``) and P4
  (``cand_score_rows``) by device time under ``torch.profiler``;
* ``fit-ml1m`` (phase 8) and ``fit-bench`` (phase 9): after a warm-up fit,
  ``--fits`` timed fits (examples/s of each, from the fit's own history) and
  one profiled fit (device busy time, idle share, launches).

    python3 scripts/torch_ab.py [--tree DIR] [--cells serve-10M,p3,...] [--fits N]

``--tree`` is the root of the checkout whose ``sbr_rs_tpu_torch`` is
imported (default: this one), so a parent commit unpacked beside it is
measured by the same cells. Prints one JSON line per cell.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

CELLS = ("serve-10M", "serve-50M-merge", "eval-10M-4096", "p3", "fit-ml1m", "fit-bench")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--tree", default=root)
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--fits", type=int, default=5)
    args = parser.parse_args()
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        sys.exit(f"torch_ab: cells are {CELLS}, got {cells}")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("torch_ab: no CUDA device")
    sys.path.insert(0, root)
    import chip_smoke as smoke

    sys.path.insert(0, os.path.abspath(args.tree))  # its sbr_rs_tpu_torch comes first
    from sbr_rs_tpu_torch import evaluation
    from sbr_rs_tpu_torch.ops import row_kernels as rowk

    dev = torch.device("cuda", 0)

    def emit(cell, **fields):
        print(json.dumps({"tree": args.tree, "cell": cell, "device": torch.cuda.get_device_name(0), **fields}),
              flush=True)

    def timed(fn):
        fn()  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return times

    for cell in cells:
        if cell.startswith("serve"):
            n = smoke.N_ITEMS_50M if cell == "serve-50M-merge" else smoke.N_ITEMS
            model = smoke.serving_model(n, dev)
            histories = smoke.serving_histories(n)
            times = timed(lambda: model.recommend_batch(histories, k=smoke.K))
            emit(cell, users_per_s=smoke.USERS / statistics.median(times), batch_ms=[t * 1e3 for t in times])
            del model
        elif cell == "eval-10M-4096":
            model = smoke.serving_model(smoke.N_ITEMS, dev)
            users = smoke.EVAL_USERS[-1]
            test = smoke.eval_test(users)
            times = timed(lambda: evaluation.mrr_score(model, test))
            emit(cell, us_per_user=statistics.median(times) * 1e6 / users, call_ms=[t * 1e3 for t in times])
            del model
        elif cell == "p3":
            gen = torch.Generator(device=dev).manual_seed(0)
            table, haug, cand = smoke.cand_inputs(smoke.BENCH_ITEMS, 33, torch.float32, 0, dev, gen)
            emit(cell, **{
                f"{fn.__name__}_device_us": smoke.device_ms(lambda: fn(haug, table, cand), reps=50) * 1e3
                for fn in (rowk.cand_score_smem, rowk.cand_score_rows)
            })
        else:
            if cell == "fit-ml1m":
                model, data = smoke.fit_ml1m_model(dev), smoke.fit_ml1m_data()
            else:
                model, data = smoke.fit_bench_model(dev), smoke.fit_bench_split()[0].to_compressed()
            model.fit(data)  # warm-up: kernel build, windows
            rates = []
            for _ in range(args.fits):
                model.fit(data)
                rates.append(model.history.examples_per_sec)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.fit(data)
                wall_ms = (time.perf_counter() - t0) * 1e3
            on_device = [
                e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            ]
            busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
            emit(cell, examples_per_sec=rates, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                 idle_share=1 - busy_ms / wall_ms, launches=sum(e.count for e in on_device))
            del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
