"""The MLA + MoE cell (``moonlight-a3b-ml20m.serve-batch``) on the CPU at a
toy size: the family's file against the port's tree and a hand count of its
operations, the near-tie rule of ``traffic/serve_batch_routed.py``, a clean
run ``correct`` and a planted fault not, the traced run's new per-layer
metrics, and the discovery of the family's files by name."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import cell, program, spec, weights
from gpubench.reference import towers

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = "moonlight-a3b-ml20m.serve-batch"
CFG_SHRINK = {"num_items": 300, "embedding_dim": 64, "hidden_size": 64, "max_sequence_length": 16,
              "num_hidden_layers": 3, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
              "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128, "moe_intermediate_size": 32,
              "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1}
TRAFFIC_SHRINK = {"users_per_batch": 16, "pool_batches": 2, "check_users": 16, "history_length_median": 9,
                  "history_lengths": [1, 40]}


def _cell():
    bench = spec.load_benchmark()
    work = spec.load_workload(NAME)
    cfg = dict(spec.load_config(bench, work["config"]), **CFG_SHRINK)
    return cfg, dict(work, traffic=dict(work["traffic"], **TRAFFIC_SHRINK))


def _traffic_module():
    return spec.traffic_module(spec.load_workload(NAME)["kind"])


def test_the_shapes_are_the_ports_initial_tree():
    from sbr_rs_tpu_torch.utils.tree import flatten

    cfg, work = _cell()
    model = spec.family_module("mla_moe").hyperparameters(cfg).embedding_dim(64).from_seed(1).build("cpu")
    port = [(path, tuple(v.shape)) for path, v in flatten(model._params["tower"])]
    shapes = spec.family_module("mla_moe").tower_shapes(cfg)
    assert [(path, tuple(shape)) for path, shape, _, _ in shapes] == port
    kinds = {path.split(".")[-1]: kind for path, _, kind, _ in shapes}
    assert kinds["router_bias"] == "b" and kinds["norm"] == kinds["kv_norm"] == kinds["attn_norm"] == "scale"
    built = program.build(cfg, 5, work["weights"], "cpu")
    leaves = weights.tower_leaves(5, cfg, work["weights"], "cpu")
    assert all(torch.equal(v, leaves[path]) for path, v in flatten(built._params["tower"]))


def test_the_operations_are_a_hand_count():
    """Layer 0 dense and two MoE layers at the toy widths: per position the
    projections q (64 x 96), kv_a (64 x 40), kv_b (32 x 128) and o (64 x
    64); the dense SwiGLU 3 x 64 x 128; a MoE layer's router 64 x 8, two
    experts' SwiGLUs 3 x 64 x 32 each and the shared one's 3 x 64 x 32; per
    key 4 heads x (24 + 16)."""
    cfg, _ = _cell()
    mla = 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    per_position = 2 * (3 * mla + 3 * 64 * 128 + 2 * (64 * 8 + 2 * 3 * 64 * 32 + 3 * 64 * 32))
    fl = spec.family_module("mla_moe").tower_flops(cfg, 5.0, 11.0)
    assert fl == 5 * per_position + 11 * 3 * 2 * 4 * (24 + 16)


def test_the_published_cut_counts_its_parameters_and_operations():
    """At the configuration's own sizes: 2.42G parameters (layer 0 83.0M,
    each MoE layer 584.8M) and 830.6 MFLOP a valid position, 10,240 an
    attended key a layer."""
    cfg = spec.load_config(spec.load_benchmark(), "moonlight-a3b-ml20m")
    family = spec.family_module("mla_moe")
    params = sum(int(np.prod(s)) for _, s, _, _ in family.tower_shapes(cfg))
    assert params == 2048 + 5 * (512 + 2048 * 576 + 512 * 4096 + 2048 * 2048 + 2048 * 3072 + 2 * 2048) \
        + 3 * 2048 * 11264 + 4 * (64 * 3 * 2048 * 1408 + 2048 * 64 + 64 + 3 * 2048 * 2816)
    assert 2.42e9 < params < 2.43e9
    assert family.tower_flops(cfg, 1.0, 0.0) == pytest.approx(830.6e6, rel=1e-3)
    assert family.tower_flops(cfg, 0.0, 1.0) == 5 * 10_240


def test_the_programs_representations_are_the_references():
    cfg, work = _cell()
    w = work["weights"]
    model = program.build(cfg, 5, w, "cpu")
    hist = [list(h) for h in np.split(*_split(cfg, 9))]
    got = np.stack([u.user_embedding for u in model.user_representations(hist)])
    leaves = weights.tower_leaves(5, cfg, w, "cpu")
    rows = lambda ids: weights.table_rows(5, ids, cfg["num_items"], cfg["embedding_dim"], w, "cpu")  # noqa: E731
    want = towers.representations(cfg, leaves, rows, hist).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)  # as tests/test_torch_mla_moe.py


def _split(cfg, count, seed=0):
    ids, lens = _traffic_module().draw(np.random.default_rng(seed), count, cfg["num_items"], _cell()[1]["traffic"])
    return ids, np.cumsum(lens)[:-1]


def test_the_lengths_are_the_laws_quantiles():
    """The cell's own parameters: every batch the same multiset of lengths,
    median 68 within 20-200, 19 % filling the window, 91.7 valid positions
    a user; the seed only orders them."""
    p = spec.load_workload(NAME)["traffic"]
    module = _traffic_module()
    a = module.lengths(np.random.default_rng(1), 512, p)
    b = module.lengths(np.random.default_rng(2), 512, p)
    assert sorted(a) == sorted(b) and a.tolist() != b.tolist()
    assert a.min() == 20 and a.max() == 200 and np.median(a) == 68
    assert 0.18 <= np.mean(a == 200) <= 0.2 and 91 < a.mean() < 92.5


def _planted(monkeypatch, margins):
    """A served batch's check with the reference's routing margins replaced
    by ``margins`` (per checked user) and the first three users' lists
    altered as a flip of their experts would alter them."""
    cfg, work = _cell()
    module = _traffic_module()
    model = program.build(cfg, 7, work["weights"], "cpu")
    hist = [list(h) for h in np.split(*_split(cfg, 16, seed=3))]
    ids, vals = model.recommend_batch(hist, k=10, exclude_seen=True, return_scores=True)
    for r in range(3):
        ids[r] = ids[r][1:] + ids[r][:1]
    ref = spec.reference_module("mla_moe")
    original = ref.representations_and_margins

    def replaced(*args, **kwargs):
        reps, _ = original(*args, **kwargs)
        return reps, torch.tensor(margins, dtype=torch.float32)

    monkeypatch.setattr(ref, "representations_and_margins", replaced)
    return module.near_tie_gaps(cfg, work, 7, "cpu", hist, ids, vals, 10)


def test_a_flip_is_excused_only_under_the_margin(monkeypatch, capsys):
    delta = spec.load_workload(NAME)["near_tie"]["margin"]
    under = [delta / 2] * 3 + [1.0] * 13
    out = _planted(monkeypatch, under)
    printed = capsys.readouterr().out
    assert out["excused_share"] == 3 / 16 and out["rank_gap"] == 0.0
    assert "excused 3" in printed and "excused user 0:" in printed and "excused user 2:" in printed
    out = _planted(monkeypatch, [delta / 2] * 2 + [delta] + [1.0] * 13)
    assert out["excused_share"] == 2 / 16 and out["rank_gap"] > 1e-3  # user 2's margin is not under delta
    out = _planted(monkeypatch, [delta / 2] * 16)  # near ties that fail nothing are not excused
    assert out["excused_share"] == 3 / 16


def test_more_excused_users_than_the_limit_fail_the_run(monkeypatch):
    """Every list altered and every user at a near tie: each user is
    excused, so the gaps read 0, and the run fails by the excused share
    alone (1 against the limit 0.02)."""
    ref = spec.reference_module("mla_moe")
    original = ref.representations_and_margins

    def tied(*args, **kwargs):
        reps, margins = original(*args, **kwargs)
        return reps, torch.zeros_like(margins)

    monkeypatch.setattr(ref, "representations_and_margins", tied)
    out = _run("answer")
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["rank_gap"]["value"] == checks["score_err"]["value"] == 0.0
    assert checks["excused_share"] == {"value": 1.0, "limit": 0.02}


def _run(fault=None, trace=False, seed=2718281829):
    cfg, work = _cell()
    return cell.run(NAME, seed, 0.3, trace, "cpu", 0.0, cfg=cfg, cell=work, fault=fault, log=lambda m: None)


def test_a_clean_run_is_correct_and_a_planted_fault_is_not():
    logged = []
    cfg, work = _cell()
    out = cell.run(NAME, 2718281829, 0.3, False, "cpu", 0.0, cfg=cfg, cell=work, log=logged.append)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["padding_routed"]["value"] == 0.0
    line = next(m for m in logged if m.startswith("window_s"))
    valid = int(line.split("'tower_positions': ")[1].split(",")[0])
    assert f"'positions': {valid}, 'routed_tokens': {2 * 2 * valid}," in line  # k = 2, two MoE layers
    out = _run("answer")
    assert out["correct"] is False, out["checks"]


def test_the_traced_run_reads_the_new_metrics():
    """On the CPU no kernel runs, so the device readers find nothing; the
    share of the peak reads the traffic's operations."""
    out = _run(trace=True)
    metrics = out["metrics"]
    assert set(metrics) == {"mfu.moe_batch", "device_idle.moe_batch"}
    assert metrics["mfu.moe_batch"]["value"] > 0


def test_the_family_is_found_by_name():
    assert spec.family_module("mla_moe").hyperparameters
    assert spec.reference_module("mla_moe").representations_and_margins
    assert _traffic_module().Traffic
    for name in ("moe_roofline", "moe_experts_ms", "moe_route_ms", "mla_attn_ms"):
        assert spec.metric_module(name + ".moe_batch").read


@pytest.mark.parametrize("trace", [0, 1])
def test_a_rehearsal_loads_no_jax_module(trace):
    out = subprocess.run(
        [sys.executable, str(HERE / "rehearse.py"), "--workload", NAME, "--seed", "4000000007", "--seconds", "0.2",
         "--trace", str(trace), "--shrink", json.dumps({"cfg": CFG_SHRINK, "traffic": TRAFFIC_SHRINK})],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden_modules"] == [] and line["correct"] is True
