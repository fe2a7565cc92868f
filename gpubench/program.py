"""The program under test, reached only through its public API: a model
built from a configuration file by the family's fluent ``Hyperparameters``
(``families/<family>.py``) and given the benchmark's weights with
``load_params``; the launch and certificate counters it keeps."""

from __future__ import annotations

from typing import Dict

import torch

from . import spec, weights


def build(cfg: Dict, seed: int, w: Dict, device):
    """The configuration's model on ``device`` with the seed's weights. The
    model's own initial draw is replaced (``load_params`` takes the tensors
    without a copy), so only one table is kept."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer

    hp = spec.family_module(cfg["family"]).hyperparameters(cfg)
    hp = (
        hp.embedding_dim(cfg["embedding_dim"])
        .learning_rate(cfg["learning_rate"])
        .l2_penalty(cfg["l2_penalty"])
        .loss(Loss(cfg["loss"]))
        .optimizer(Optimizer(cfg["optimizer"]))
        .batch_size(cfg["batch_size"])
        .sparse_updates(cfg["sparse_updates"])
        .packed(cfg["packed"])
        .table_dtype(cfg["table_dtype"])
        .from_seed(weights.derived_seed(seed, 3) % (2**31))
    )
    model = hp.build(device)
    table = weights.make_table(
        seed, cfg["num_items"], cfg["embedding_dim"], w, device, getattr(torch, cfg["table_dtype"])
    )
    leaves = weights.tower_leaves(seed, cfg, w, device)
    model.load_params({"item_table": table, "tower": weights.nest(leaves)})
    return model


def counters() -> Dict[str, int]:
    """The counters' current values, by the names ``counters/*.json`` give
    them: an attribute of a function object of the program, such as
    ``launches`` of every hand-written kernel's wrapper or
    ``rechecked_users`` of the streamed top-k's certificate (a counter the
    program lacks is left out)."""
    import importlib

    out = {}
    for name, (module, fn, attr) in spec.counters().items():
        try:
            value = getattr(getattr(importlib.import_module(module), fn), attr)
        except (ImportError, AttributeError):
            continue
        out[name] = int(value)
    return out


def rechecked_users() -> int:
    """``topk_streamed.rechecked_users``: users the certificate has sent to
    the FP32 recheck so far."""
    from sbr_rs_tpu_torch.models import base

    return int(base.topk_streamed.rechecked_users)


def last_route():
    """``topk_streamed.last_route``: the last streamed top-k's route and
    budgets, or ``None``."""
    from sbr_rs_tpu_torch.models import base

    return getattr(base.topk_streamed, "last_route", None)
