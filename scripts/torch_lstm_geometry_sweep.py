#!/usr/bin/env python3
"""Time K1 and K2's recurrence (``sbr_rs_tpu_torch/csrc/lstm_fwd.cu``,
``csrc/lstm_bwd.cu``) in every geometry that ``ops/lstm_kernels.py
recurrence_candidates`` allows, at the shapes the port's paths give them,
beside the geometry ``recurrence_geometry`` picks. On one CUDA card, from the
root of a checkout:

    python3 scripts/torch_lstm_geometry_sweep.py [--out sweep.jsonl]

Each geometry's output is held against the picked geometry's within 1e-5
and counted where it is bit-equal (the forward's sums run in the same order
in every geometry; a cluster of another size adds the backward's dh partial
sums in another order). Prints, per shape and direction, the picked
geometry's time and the five fastest, and writes every timing as one JSON
line per geometry to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (name, T, B, D, coupled): the ml1m fit, the fit-10M-sparse fit, the
# bench.py fit, the serving / eval-4096 batch and the eval-512 batch.
SHAPES = [
    ("fit-ml1m", 128, 256, 128, True),
    ("fit-10M-sparse", 64, 256, 127, True),
    ("fit-bench", 32, 256, 32, False),
    ("serve-10M", 32, 4096, 127, False),
    ("eval-10M-512", 32, 512, 127, False),
]
TOL = 1e-5


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_lstm_geometry_sweep: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from sbr_rs_tpu_torch.ops import lstm_kernels as lk

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="JSON lines of every timing")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    lines, failed = [], []
    for name, t_len, b, d, coupled in SHAPES:
        gates = 3 if coupled else 4
        xz = torch.randn((t_len, b, gates * d), device=dev, generator=gen)
        w_h = torch.randn((d, gates * d), device=dev, generator=gen) * d**-0.5
        keep = (torch.rand((t_len, b, 1), device=dev, generator=gen) >= 0.1).float()
        g = torch.randn((t_len, b, d), device=dev, generator=gen)
        for backward in (False, True):
            picked = lk.recurrence_geometry(b, d, gates, sms, backward=backward)
            h, c = lk._fwd_launch(xz, w_h, keep, coupled, lk.recurrence_geometry(b, d, gates, sms))

            def run(geometry):
                if backward:
                    return lk._bwd_launch(xz, w_h, h, c, g, keep, coupled, geometry)
                return lk._fwd_launch(xz, w_h, keep, coupled, geometry)

            want = run(picked)
            want = (want,) if backward else want
            results, equal = [], 0
            for cluster, rows, threads, smem in lk.recurrence_candidates(b, d, gates, sms, backward=backward):
                geometry = (cluster, rows, threads, smem, "smem")
                got = run(geometry)
                got = (got,) if backward else got
                err = max(float((x - y).abs().max()) for x, y in zip(got, want))
                if not err <= TOL:
                    failed.append(f"{name} {'backward' if backward else 'forward'} {geometry}: differs from "
                                  f"{picked} by {err:.3e}")
                    print(f"FAILED {failed[-1]}", flush=True)
                equal += all(torch.equal(x, y) for x, y in zip(got, want))
                ms = time_ms(lambda: run(geometry))
                rt = lk.rows_per_thread(d, cluster, rows, threads)
                results.append((ms, cluster, rows, threads, rt))
                lines.append({"shape": name, "backward": backward, "cluster": cluster, "rows": rows,
                              "threads": threads, "rows_per_thread": rt, "ms": ms,
                              "picked": geometry == picked})
            picked_ms = time_ms(lambda: run(picked))
            direction = "K2 recurrence" if backward else "K1"
            print(f"{name} (T={t_len} B={b} D={d} {'coupled' if coupled else 'normal'}) {direction}: picked "
                  f"cluster {picked[0]}, {picked[1]} rows, {picked[2]} threads: {picked_ms:.3f} ms; "
                  f"{len(results)} geometries, {equal} bit-equal to it; fastest:", flush=True)
            for ms, cluster, rows, threads, rt in sorted(results)[:5]:
                print(f"  {ms:.3f} ms: cluster {cluster}, {rows} rows, {threads} threads, {rt} rows a thread",
                      flush=True)
        del xz, w_h, keep, g, h, c
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    if failed:
        sys.exit(f"{len(failed)} geometries differ from the picked one beyond {TOL:.0e}")


if __name__ == "__main__":
    main()
