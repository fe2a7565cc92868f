"""The program under test, reached only through its public API: a model
built from a configuration file by the family's fluent ``Hyperparameters``
and given the benchmark's weights with ``load_params``; the launch and
certificate counters it keeps."""

from __future__ import annotations

from typing import Dict

import torch

from . import weights


def build(cfg: Dict, seed: int, w: Dict, device):
    """The configuration's model on ``device`` with the seed's weights. The
    model's own initial draw is replaced (``load_params`` takes the tensors
    without a copy), so only one table is kept."""
    from sbr_rs_tpu_torch.models import Loss, Optimizer, attention, lstm

    family = cfg["family"]
    if family == "lstm":
        hp = lstm.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"]).lstm_variant(
            lstm.LSTMVariant(cfg["lstm_variant"])
        )
    elif family == "attention":
        hp = (
            attention.Hyperparameters(cfg["num_items"], cfg["max_sequence_length"])
            .num_layers(cfg["num_layers"])
            .num_heads(cfg["num_heads"])
            .dropout(cfg["dropout"])
        )
    else:
        raise ValueError(f"unknown family {family!r}")
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


# The program's counters, by (module, function) name, each an attribute of
# the function object: ``launches`` of every hand-written kernel's wrapper,
# ``rechecked_users`` of the streamed top-k's certificate.
COUNTERS = {
    "lstm_fwd": ("sbr_rs_tpu_torch.ops.lstm_kernels", "lstm_fwd", "launches"),
    "lstm_bwd": ("sbr_rs_tpu_torch.ops.lstm_kernels", "lstm_bwd", "launches"),
    "lstm_bwd_dwh": ("sbr_rs_tpu_torch.ops.lstm_kernels", "lstm_bwd_dwh", "launches"),
    "score_groupmax": ("sbr_rs_tpu_torch.ops.topk_kernels", "score_groupmax", "launches"),
    "score_groupmax_fp32": ("sbr_rs_tpu_torch.ops.topk_kernels", "score_groupmax_fp32", "launches"),
    "score_submax_groupmax": ("sbr_rs_tpu_torch.ops.topk_kernels", "score_submax_groupmax", "launches"),
    "score_submax_groupmax_fp32": ("sbr_rs_tpu_torch.ops.topk_kernels", "score_submax_groupmax_fp32", "launches"),
    "score_count_ge": ("sbr_rs_tpu_torch.ops.topk_kernels", "score_count_ge", "launches"),
    "gather_rows": ("sbr_rs_tpu_torch.ops.row_kernels", "gather_rows", "launches"),
    "scatter_add_rows_": ("sbr_rs_tpu_torch.ops.row_kernels", "scatter_add_rows_", "launches"),
    "cand_score_smem": ("sbr_rs_tpu_torch.ops.row_kernels", "cand_score_smem", "launches"),
    "cand_score_rows": ("sbr_rs_tpu_torch.ops.row_kernels", "cand_score_rows", "launches"),
    "rechecked_users": ("sbr_rs_tpu_torch.models.base", "topk_streamed", "rechecked_users"),
}


def counters() -> Dict[str, int]:
    """The counters' current values (a counter the program lacks is left out)."""
    import importlib

    out = {}
    for name, (module, fn, attr) in COUNTERS.items():
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
