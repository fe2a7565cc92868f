"""The plain reference against the port on the CPU, at toy sizes, from the
benchmark's own weights: the towers and the full-catalog top-k."""

import numpy as np
import pytest
import torch

from gpubench import gen, program, spec, weights
from gpubench.reference import topk, towers

W_SERVE = {"embedding_std": 0.25, "bias_std": 0.05, "tower_bias_std": 0.1}


def _cfg(name, **over):
    bench = spec.load_benchmark()
    return dict(spec.load_config(bench, name), **over)


@pytest.mark.parametrize("variant", ["normal", "coupled"])
def test_lstm_representations_match_the_port(variant):
    cfg = _cfg("lstm32-items50m", num_items=700, embedding_dim=12, max_sequence_length=8, lstm_variant=variant)
    model = program.build(cfg, 5, W_SERVE, "cpu")
    hist = gen.histories(np.random.default_rng(0), 9, 700, 1, 12, 1.05)
    got = np.stack([u.user_embedding for u in model.user_representations(hist)])
    leaves = weights.tower_leaves(5, cfg, W_SERVE, "cpu")
    rows = lambda ids: weights.table_rows(5, ids, 700, 12, W_SERVE, "cpu")
    want = towers.representations(cfg, leaves, rows, hist).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sasrec_tower_matches_the_port():
    from sbr_rs_tpu_torch.models.towers import attention_apply

    # The attention family's shapes (SASRec's blocks), for a later
    # configuration of that family.
    cfg = {"family": "attention", "embedding_dim": 8, "max_sequence_length": 10, "num_layers": 2, "num_heads": 2}
    leaves = weights.tower_leaves(3, cfg, W_SERVE, "cpu")
    x = torch.randn((4, 10, 8), generator=torch.Generator().manual_seed(1))
    got = attention_apply(weights.nest(leaves), x, num_heads=2)
    want = towers.apply(cfg, leaves, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_catalog_topk_matches_the_ports_streamed_route():
    n = 140_000  # past one serving chunk: the streamed route
    cfg = _cfg("lstm32-items50m", num_items=n, embedding_dim=7, max_sequence_length=6)
    model = program.build(cfg, 9, W_SERVE, "cpu")
    hist = gen.histories(np.random.default_rng(2), 5, n, 2, 9, 1.05)
    ids, vals = model.recommend_batch(hist, k=6, return_scores=True)
    leaves = weights.tower_leaves(9, cfg, W_SERVE, "cpu")
    reps = towers.representations(cfg, leaves, lambda i: weights.table_rows(9, i, n, 7, W_SERVE, "cpu"), hist)
    asked = torch.tensor(ids)
    ref_v, ref_i, asked_s = topk.catalog_topk(reps, hist, 6, weights.chunks(9, n, 7, W_SERVE, "cpu"), asked)
    assert ref_i.tolist() == ids
    rank_gap, score_err = topk.served_gaps(ref_v, asked_s, ids, n, torch.tensor(vals))
    assert rank_gap <= 1e-6 and score_err <= 1e-6
