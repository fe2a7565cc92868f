"""The MLA + MoE cell's router, program against the plain reference, on the
card: the numbers behind the near-tie rule of
``gpubench/traffic/serve_batch_routed.py``.

Builds ``moonlight-a3b-ml20m`` with the benchmark's weights of each of
``--seeds`` seeds, draws one batch of its traffic
(``serve_batch_routed.draw``), and serves it once through
``recommend_batch`` with the port's router (``models/towers.py
moe_route``) wrapped to record each MoE layer's biased choice scores
``sigmoid(x W_router) + b`` of the valid positions. The reference
(``gpubench/reference/mla_moe.py forward``, TF32 off, from the model's
own parameters) computes the same windows in blocks. Per MoE layer it
reports:

* the largest difference of the choice scores, over the users whose
  experts agreed at every token of the layers before (so that both sides
  read the same inputs up to rounding);
* the tokens and users whose top-k experts differ (flips), and the
  reference's margin (k-th less (k+1)-th choice score) at each flip;
* how many tokens have a margin under 1e-7, 1e-6, 1e-5 and 1e-4.

Then the representations' largest difference over the users with no flip,
relative to each user's largest component, and the batch's host seconds
and peak device memory.

Run from the repository's root on a card::

    python3 scripts/mla_moe_router_probe.py [--seeds 11,12,13] [--users 512]

Writes ``chiprun_out/mla_moe_router_probe.json``.
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

from gpubench import program, spec, weights  # noqa: E402
from gpubench.reference import precision  # noqa: E402
from gpubench.traffic import serve_batch_routed  # noqa: E402
from sbr_rs_tpu_torch.models import towers  # noqa: E402
from sbr_rs_tpu_torch.utils.tree import flatten  # noqa: E402

CELL = "moonlight-a3b-ml20m.serve-batch"
THRESHOLDS = (1e-7, 1e-6, 1e-5, 1e-4)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def probe(seed: int, users: int, block: int, device: str = "cuda", shrink: dict = None) -> dict:
    bench = spec.load_benchmark()
    cell = spec.load_workload(CELL)
    cfg = dict(spec.load_config(bench, cell["config"]), **(shrink or {}))
    p = cell["traffic"]
    k = int(cfg["num_experts_per_tok"])
    model = program.build(cfg, seed, cell["weights"], device)
    rng = np.random.default_rng(weights.derived_seed(seed, 40))
    ids, lens = serve_batch_routed.draw(rng, users, cfg["num_items"], p)
    hist = np.split(ids, np.cumsum(lens)[:-1])

    captured = []
    route = towers.moe_route

    def recording(x, router, bias, kk, scaling):
        captured.append((torch.sigmoid(x @ router) + bias).cpu())
        return route(x, router, bias, kk, scaling)

    cuda = device == "cuda"
    model.recommend_batch(hist, k=10, return_scores=True)  # warm
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model.recommend_batch(hist, k=10, return_scores=True)
    batch_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    towers.moe_route = recording
    try:
        reps = torch.from_numpy(np.stack([u.user_embedding for u in model.user_representations(hist)]))
    finally:
        towers.moe_route = route
    leaves = dict(flatten(model._params["tower"]))
    table = model._params["item_table"]
    del model
    if cuda:
        torch.cuda.empty_cache()

    n_win = int(cfg["max_sequence_length"])
    windows = [h[-n_win:] for h in hist]
    keep = np.array([len(w) for w in windows])
    ref_choices, ref_reps = [], []
    ref = spec.reference_module(cfg["family"])
    with precision(False), torch.no_grad():
        for a in range(0, users, block):
            ws = windows[a : a + block]
            width = max(len(w) for w in ws)
            x = torch.zeros((len(ws), width, cfg["embedding_dim"]), device=device)
            for r, w in enumerate(ws):
                x[r, : len(w)] = table[torch.from_numpy(w).to(device), :-1]
            out, choices = ref.forward(cfg, leaves, x)
            last = torch.tensor([len(w) - 1 for w in ws], device=device)
            ref_reps.append(out[torch.arange(len(ws), device=device), last].cpu())
            # Valid positions in the program's order: user by user, position by position.
            ref_choices.append([torch.cat([c[r, : len(w)] for r, w in enumerate(ws)]).cpu() for c in choices])
    ref_reps = torch.cat(ref_reps)
    ref_layers = [torch.cat(parts) for parts in zip(*ref_choices)]
    owner = torch.from_numpy(np.repeat(np.arange(users), keep))
    diverged = torch.zeros(users, dtype=torch.bool)
    layers = []
    for mine, theirs in zip(captured, ref_layers):
        same_inputs = ~diverged[owner]
        diff = (mine - theirs).abs().amax(dim=1)
        top = torch.topk(theirs, k + 1, dim=1).values
        margin = top[:, k - 1] - top[:, k]
        flips = (torch.topk(mine, k, dim=1).indices.sort(dim=1).values
                 != torch.topk(theirs, k, dim=1).indices.sort(dim=1).values).any(dim=1)
        layers.append({
            "max_choice_diff_same_inputs": float(diff[same_inputs].max()) if same_inputs.any() else None,
            "p99_choice_diff_same_inputs": float(diff[same_inputs].quantile(0.99)) if same_inputs.any() else None,
            "flipped_tokens": int(flips.sum()),
            "flipped_tokens_same_inputs": int((flips & same_inputs).sum()),
            "flip_margins": sorted(float(m) for m in margin[flips])[:20],
            "tokens": int(len(margin)),
            "tokens_with_margin_under": {str(t): int((margin < t).sum()) for t in THRESHOLDS},
        })
        diverged[owner[flips]] = True
    clean = ~diverged
    scale = ref_reps.abs().amax(dim=1)
    rel = ((reps - ref_reps).abs().amax(dim=1) / scale)
    return {
        "seed": seed, "users": users, "valid_positions": int(keep.sum()), "batch_s": batch_s,
        "peak_bytes": int(peak), "layers": layers, "users_with_a_flip": int(diverged.sum()),
        "rep_rel_diff_clean_max": float(rel[clean].max()) if clean.any() else None,
        "rep_rel_diff_flipped_min": float(rel[diverged].min()) if diverged.any() else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--users", type=int, default=512)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", default="{}", help="configuration keys to set, as JSON (a CPU trial at a toy size)")
    args = ap.parse_args(argv)
    out = {"card": card(), "torch": torch.__version__, "runs": []}
    print(out["card"], flush=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = probe(seed, args.users, args.block, args.device, json.loads(args.shrink))
        print(json.dumps(run), flush=True)
        out["runs"].append(run)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/mla_moe_router_probe.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
