"""Random hyperparameter search for the PyTorch port.

The port's counterpart of ``examples/lstm_hyperopt.py`` (reference
``examples/lstm_hyperopt.rs:82-130``): each trial draws random
hyperparameters (``Hyperparameters.random``, the JAX package's draws), fits,
scores train and test MRR, and appends the result to the output file, kept
sorted by test MRR (best last).

Usage::

    python examples/torch_lstm_hyperopt.py [--trials N] [--out FILE]
        [--model lstm|ewma|attention|gru] [--seed N]
        [--dataset synthetic|movielens] [--device cuda|cpu] [--synthetic-users N]

The output defaults to ``torch_<model>_results.json``. ``synthetic`` (the
default) is ``synthetic_interactions(943, 1682, 106)``, ML-100K's shape;
``--synthetic-users`` makes it smaller. ``movielens`` reads or downloads
ML-100K. The trials run on the card unless ``--device cpu``; without CUDA the
card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu_torch as sbr
from sbr_rs_tpu_torch.models import attention, ewma, gru, lstm

MODEL_FAMILIES = {"lstm": lstm, "ewma": ewma, "attention": attention, "gru": gru}


def load_data(dataset: str, synthetic_users: int) -> "sbr.data.Interactions":
    """ML-100K, or synthetic data of its shape (943 x 1682 x 106) with
    ``synthetic_users`` users."""
    if dataset == "movielens":
        return sbr.datasets.download_movielens_100k()
    return sbr.datasets.synthetic_interactions(synthetic_users, 1682, 106, rng=0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--trials", type=int, default=1000)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--model", choices=sorted(MODEL_FAMILIES), default="lstm")
    parser.add_argument("--dataset", choices=("synthetic", "movielens"), default="synthetic")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--synthetic-users", type=int, default=943)
    args = parser.parse_args(argv)
    family = MODEL_FAMILIES[args.model]
    out = Path(args.out or f"torch_{args.model}_results.json")

    data = load_data(args.dataset, args.synthetic_users)
    rng = np.random.default_rng(args.seed)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()
    # The reference's startup line, with the total (pre-split) interaction
    # count (``examples/lstm_hyperopt.rs:93-98``).
    print(f"Train {train_mat.num_users} {train_mat.num_items} {len(data)}")

    for _ in range(args.trials):
        results = json.loads(out.read_text()) if out.exists() else []

        hyper = family.Hyperparameters.random(data.num_items, rng)
        print(f"Running {json.dumps(hyper.to_dict(), indent=2)}")

        start = time.perf_counter()
        try:
            model = hyper.build(args.device)
            model.fit(train_mat)
            result = {
                "train_mrr": sbr.evaluation.mrr_score(model, train_mat),
                "test_mrr": sbr.evaluation.mrr_score(model, test_mat),
                "elapsed_s": time.perf_counter() - start,
                "device": str(model.device),
                "hyperparameters": hyper.to_dict(),
            }
        except sbr.errors.SbrError as exc:
            # Random-search corners diverge (lr up to ~3.2): record and move
            # on rather than abort a long search.
            print(f"Trial failed ({exc!r}); continuing")
            continue
        print(json.dumps(result, indent=2))

        if not np.isnan(result["test_mrr"]):
            results.append(result)
            results.sort(key=lambda r: r["test_mrr"])
        if results:
            print(f"Best result: {json.dumps(results[-1], indent=2)}")

        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(results, indent=2))
        os.replace(tmp, out)


if __name__ == "__main__":
    main()
