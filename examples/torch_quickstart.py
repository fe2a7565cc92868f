"""Quickstart for the PyTorch port: fit an LSTM ranking model, evaluate MRR,
save it, load it back and serve from the copy.

The port's counterpart of ``examples/quickstart.py`` (the reference's README
example, ``src/lib.rs:22-58``): a user-based split, an LSTM with WARP loss,
test MRR, the serving path (encode a history, score candidates), then a
checkpoint round trip (``model.save`` / ``ImplicitSequenceModel.load``)
whose copy must serve the same top-10 lists.

Usage::

    python examples/torch_quickstart.py [--dataset synthetic|movielens]
        [--device cuda|cpu] [--epochs N] [--synthetic-users N] [--checkpoint DIR]

``synthetic`` (the default) is ``synthetic_interactions(943, 1682, 106)``,
ML-100K's shape; ``--synthetic-users`` makes it smaller. ``movielens``
reads or downloads ML-100K (``datasets.download_movielens_100k``). The model
runs on the card unless ``--device cpu``; without CUDA the card raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sbr_rs_tpu_torch as sbr
from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel


def load_data(dataset: str, synthetic_users: int) -> "sbr.data.Interactions":
    """ML-100K, or synthetic data of its shape (943 x 1682 x 106) with
    ``synthetic_users`` users."""
    if dataset == "movielens":
        return sbr.datasets.download_movielens_100k()
    return sbr.datasets.synthetic_interactions(synthetic_users, 1682, 106, rng=0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", choices=("synthetic", "movielens"), default="synthetic")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--synthetic-users", type=int, default=943)
    parser.add_argument("--checkpoint", default=None, help="where to save the model (default: a temporary directory)")
    args = parser.parse_args(argv)

    data = load_data(args.dataset, args.synthetic_users)
    print(f"Loaded {len(data)} interactions ({args.dataset}): {data.num_users} users x {data.num_items} items")

    rng = np.random.default_rng(42)
    train, test = sbr.data.user_based_split(data, rng, 0.2)
    train_mat = train.to_compressed()
    test_mat = test.to_compressed()

    model = (
        lstm.Hyperparameters(data.num_items, 32)
        .embedding_dim(32)
        .learning_rate(0.16)
        .l2_penalty(0.0004)
        .lstm_variant(lstm.LSTMVariant.NORMAL)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(args.epochs)
        .batch_size(32)
        .from_seed(42)
        .build(args.device)
    )

    start = time.perf_counter()
    loss = model.fit(train_mat)
    print(f"Fit on {args.device} in {time.perf_counter() - start:.2f}s: mean loss {loss:.4f}")
    print(model.history.summary())

    mrr = sbr.evaluation.mrr_score(model, test_mat)
    print(f"Test MRR: {mrr:.4f}")

    # Serving: encode a user's history, score candidate items.
    history = test_mat.get_user(next(u.user_id for u in test_mat.iter_users() if len(u) >= 2))
    rep = model.user_representation(history.item_ids[:-1])
    candidates = [int(history.item_ids[-1]), 0, 1, 2]
    for item, score in zip(candidates, model.predict(rep, candidates)):
        print(f"  item {item:5d}: {score:8.4f}")

    # A checkpoint round trip: the copy serves what the model serves.
    histories = [test_mat.get_user(u.user_id).item_ids.tolist() for u in test_mat.iter_users() if len(u)][:16]
    with tempfile.TemporaryDirectory() as tmp:
        path = args.checkpoint or os.path.join(tmp, "model")
        model.save(path)
        copy = ImplicitSequenceModel.load(path, args.device)
        ids = model.recommend_batch(histories, k=10)
        if copy.recommend_batch(histories, k=10) != ids:
            raise RuntimeError(f"the model loaded from {path} serves other lists than the saved model")
        print(f"Saved to and loaded from {path}: the copy serves the same top-10 to {len(ids)} users")
        print(f"  first user: {ids[0]}")


if __name__ == "__main__":
    main()
