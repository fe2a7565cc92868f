"""Readings that set a cell's limits, on the card at the cell's own size,
several seeds in one process: the program's numbers (a short window, as a
run makes them), the control's (the plain reference computed in TF32, the
precision below the configuration's, put in the program's place) and those
of each fault a cell can have, planted in the program (each list's last
answer altered). One JSON line a seed.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 --seconds 3 \
        [--faults answer] [--no-control]"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))


def readings(name, seed, seconds, fault=None, control=False, device="cuda", cfg=None, cell=None):
    import torch

    from gpubench import spec
    from gpubench.cell import Context

    bench = spec.load_benchmark()
    cell = cell or spec.load_workload(name)
    cfg = cfg or spec.load_config(bench, cell["config"])
    traffic = spec.traffic_module(cell["kind"]).Traffic(Context(cfg, cell, seed, device, fault))
    traffic.warm()
    traffic.open_window()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        traffic.step()
    traffic.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out = {"program": traffic.checks()}
    if control:
        out["control"] = traffic.checks(control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = {"workload": args.workload, "seed": seed}
        line.update(readings(args.workload, seed, args.seconds, control=not args.no_control))
        for fault in [f for f in args.faults.split(",") if f]:
            line["fault_" + fault] = readings(args.workload, seed, args.seconds, fault=fault)["program"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
