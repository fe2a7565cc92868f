"""The harness's arithmetic, held to values recorded on commit
a2a2d394a2c8e21581d9a4f4e3c50e1d9aedbca4, before the model families, counters
and kernel maps moved into files of their own (``families/``,
``reference/<family>.py``, ``counters/``, ``kernels/``): for seed 5 on the
CPU at toy sizes, the sha256 of the tower leaves (``weights.tower_leaves``)
and of the reference's representations of 9 histories, and the FLOP count
of one served batch (``flops.serve_batch``). Bit for bit: the same seed has
to give the program and the reference the same weights, and ``mfu.*`` the
same operations."""

import hashlib

import numpy as np
import pytest

from gpubench import flops, gen, spec, weights
from gpubench.reference import towers

W = {"embedding_std": 0.25, "bias_std": 0.05, "tower_bias_std": 0.1}
LENGTHS = [1, 2, 3, 5, 8, 13, 21, 34]
ATTENTION = {"family": "attention", "num_items": 700, "embedding_dim": 8, "max_sequence_length": 10,
             "num_layers": 2, "num_heads": 2}
GOLDEN = {  # leaves, representations, FLOPs of LENGTHS over 1,000 items
    "lstm_normal": ("cc3cfdf2bb45473409558233619fd64ca0f9c2eb5180313e3295bec83276f27d",
                    "72589771034ac45750f1b226998bee757ab2a0d5c527c8b520dfefb1af079578", 307072.0),
    "lstm_coupled": ("fb254e03bd8b17261303c60a914d017b06b3ad69e7aee782c01d2ed55b371496",
                     "50519841d863b4d1ac8abe4029f142b6107ad5a998f454cfc0d40520b7cdf4d8", 282304.0),
    "attention": ("ab1219f4b9314b5dc7218cbffb4425a680c9a8f6fd6340e67b484275be93c6b9",
                  "63469a8add17160ddf17fd9c2078ec67e24854c53119ae22c3b0150af5db9360", 233728.0),
}
# The program's counters and kernel maps as ``program.COUNTERS`` and
# ``kernels.json`` held them.
COUNTERS = {
    **{k: ["sbr_rs_tpu_torch.ops.lstm_kernels", k, "launches"] for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_dwh")},
    **{k: ["sbr_rs_tpu_torch.ops.topk_kernels", k, "launches"] for k in (
        "score_groupmax", "score_groupmax_fp32", "score_submax_groupmax", "score_submax_groupmax_fp32",
        "score_count_ge")},
    **{k: ["sbr_rs_tpu_torch.ops.row_kernels", k, "launches"] for k in (
        "gather_rows", "scatter_add_rows_", "cand_score_smem", "cand_score_rows")},
    "rechecked_users": ["sbr_rs_tpu_torch.models.base", "topk_streamed", "rechecked_users"],
}
KERNELS = {
    "score_submax_kernel": ["score_submax_groupmax", "score_groupmax"],
    "score_groupmax_kernel": ["score_submax_groupmax_fp32", "score_groupmax_fp32"],
    "score_count_kernel": ["score_count_ge"],
    "lstm_fwd_(smem|l2)_kernel": ["lstm_fwd"],
    "lstm_bwd_(smem|l2)_kernel": ["lstm_bwd"],
    "lstm_bwd_dwh_kernel": ["lstm_bwd_dwh"],
    "gather_rows_kernel": ["gather_rows"],
    "scatter_add_rows_kernel": ["scatter_add_rows_"],
    "cand_score_smem_kernel": ["cand_score_smem"],
    "cand_score_rows_kernel": ["cand_score_rows"],
}


def _cfg(name):
    if name == "attention":
        return ATTENTION
    base = spec.load_config(spec.load_benchmark(), "lstm32-items50m")
    return dict(base, num_items=700, embedding_dim=12, max_sequence_length=8, lstm_variant=name[len("lstm_"):])


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_leaves_representations_and_flops_are_the_recorded_ones(name):
    cfg = _cfg(name)
    leaves = weights.tower_leaves(5, cfg, W, "cpu")
    h = hashlib.sha256()
    for path, v in leaves.items():
        h.update(path.encode())
        h.update(v.numpy().tobytes())
    d = cfg["embedding_dim"]
    hist = gen.histories(np.random.default_rng(0), 9, 700, 1, 12, 1.05)
    reps = towers.representations(cfg, leaves, lambda ids: weights.table_rows(5, ids, 700, d, W, "cpu"), hist)
    got = (h.hexdigest(), hashlib.sha256(reps.numpy().tobytes()).hexdigest(), flops.serve_batch(cfg, LENGTHS, 1000))
    assert got == GOLDEN[name]


def test_the_cells_flops_are_the_recorded_ones():
    cfg = spec.load_config(spec.load_benchmark(), "lstm32-items50m")
    assert flops.serve_batch(cfg, list(range(2, 32)) * 3, cfg["num_items"]) == 297024330240.0
    assert flops.serve_batch(cfg, [17], cfg["num_items"]) == 3300278528.0


@pytest.mark.parametrize("merged,recorded", [(spec.counters, COUNTERS), (spec.kernel_map, KERNELS)])
def test_merged_counters_and_kernel_maps_are_the_recorded_ones(merged, recorded):
    assert merged() == recorded
