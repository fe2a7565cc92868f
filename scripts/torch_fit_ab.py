#!/usr/bin/env python3
"""Training throughput of one checkout of the port, for A/B runs of two
trees in turns on one card, in the configurations of ``chip_smoke.py``:
``ml1m`` (phase 8: ML-1M-shaped synthetic data, 6040 x 3706 x 165; Coupled
LSTM-128, T=128, Hinge, Adam, lr 0.05, packed, batch 256, one epoch, seed 0)
or ``bench`` (phase 9: ML-100K-shaped synthetic data, 943 x 1682 x 106, the
training users of a 0.2 user split; Normal LSTM-32, T=32, WARP, Adagrad, lr
0.16, l2 4e-4, packed, batch 256, 10 epochs, seed 42).

    python3 scripts/torch_fit_ab.py [--tree DIR] [--config ml1m|bench] [--fits N]

``--tree`` is the root of the checkout whose ``sbr_rs_tpu_torch`` is
imported (default: this one), so a parent commit unpacked beside it can be
measured by the same script. After a warm-up fit it times ``--fits`` fits
(examples/s of each, from the fit's own history) and profiles one more
(device busy time, idle share, launches), and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--config", choices=("ml1m", "bench"), default="ml1m")
    parser.add_argument("--fits", type=int, default=5)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("torch_fit_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    from sbr_rs_tpu_torch import data as sbr_data
    from sbr_rs_tpu_torch import datasets
    from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

    dev = torch.device("cuda", 0)
    if args.config == "ml1m":
        data = datasets.synthetic_interactions(6040, 3706, 165, rng=0).to_compressed()
        model = (
            lstm.Hyperparameters(3706, 128).embedding_dim(128).learning_rate(0.05).loss(Loss.HINGE)
            .optimizer(Optimizer.ADAM).lstm_variant(lstm.LSTMVariant.COUPLED).num_epochs(1).batch_size(256)
            .packed(True).from_seed(0).build(dev)
        )
    else:
        raw = datasets.synthetic_interactions(943, 1682, 106, rng=0)
        data = sbr_data.user_based_split(raw, np.random.default_rng(42), 0.2)[0].to_compressed()
        model = (
            lstm.Hyperparameters(1682, 32).embedding_dim(32).learning_rate(0.16).l2_penalty(4e-4)
            .lstm_variant(lstm.LSTMVariant.NORMAL).loss(Loss.WARP).optimizer(Optimizer.ADAGRAD).num_epochs(10)
            .batch_size(256).packed(True).from_seed(42).build(dev)
        )
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
    print(json.dumps({
        "tree": args.tree, "config": args.config, "device": torch.cuda.get_device_name(0), "examples_per_sec": rates,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "launches": sum(e.count for e in on_device),
    }), flush=True)


if __name__ == "__main__":
    main()
