"""Run one cell of the benchmark on the card and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, the kernels loaded from the program's build cache, weights
drawn on the card from the seed, the traffic drawn on the host), a warm-up
of the cell's own shapes, ``--seconds`` of closed-loop work, then the
check against the plain reference. The last line of standard output is
one JSON object: the end-to-end metrics (``--trace 0``) or the per-layer
metrics and the breakdown (``--trace 1``), ``correct`` and the numbers
compared with their limits. Without a CUDA card, or with fewer cards than
the cell asks for, or with JAX or the JAX package loaded, it prints no
result and exits non-zero."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds; no library loads JAX.
for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[key] = str(ROOT / "build" / "gpubench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_state() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import cell, spec

    bench = spec.load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        err(f"BENCHMARK.json has no workload {args.workload!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        err(f"this cell needs {entry['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                      log=lambda m: print(m, flush=True))
    found = cell.forbidden_modules()
    if found:
        err(f"modules of JAX or the JAX package were loaded: {found}: no result")
        return 4
    print(f"card {card_state()}", flush=True)
    err(f"correct {result['correct']}")
    for name, c in result["checks"].items():  # the last lines of standard error
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
