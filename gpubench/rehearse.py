"""A rehearsal of a cell on the CPU at a toy size: the cell's traffic,
set-up, window and check with its configuration shrunk (``--shrink``
sets keys of the configuration and of the workload's traffic), the
program's plain CPU paths in place of its kernels. It prints what the run
would and reports nothing as a device metric. For tests and for trying a
change before the card; the benchmark itself never falls back to the CPU.

    python gpubench/rehearse.py --workload <cell> --seed 3 --seconds 1 \
        --shrink '{"cfg": {"num_items": 300000}, "traffic": {"users_per_batch": 64}}'"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--shrink", default="{}")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from gpubench import cell, spec

    torch.set_num_threads(2)
    shrink = json.loads(args.shrink)
    bench = spec.load_benchmark()
    work = spec.load_workload(args.workload)
    cfg = dict(spec.load_config(bench, work["config"]), **shrink.get("cfg", {}))
    work = dict(work, traffic=dict(work["traffic"], **shrink.get("traffic", {})))
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cpu", T_START,
                      cfg=cfg, cell=work, fault=args.fault, log=lambda m: print(m, flush=True))
    result["forbidden_modules"] = cell.forbidden_modules()
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
