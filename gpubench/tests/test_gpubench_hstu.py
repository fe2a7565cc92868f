"""The HSTU cell (``hstu-ml20m-large.serve-batch``) on the CPU at a toy
size: the program against the benchmark's plain reference, the timed
traffic, a clean run ``correct`` and a planted fault not, the traced run's
new per-layer metrics, and the family's operation count."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import cell, program, spec, weights
from gpubench.reference import towers
from gpubench.reference.hstu import time_bucket

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NAME = "hstu-ml20m-large.serve-batch"
CFG_SHRINK = {"num_items": 300, "embedding_dim": 8, "max_sequence_length": 16, "num_layers": 2}
TRAFFIC_SHRINK = {"users_per_batch": 16, "pool_batches": 2, "check_users": 16, "history_length_median": 9,
                  "history_lengths": [1, 40]}


def _cell():
    bench = spec.load_benchmark()
    work = spec.load_workload(NAME)
    cfg = dict(spec.load_config(bench, work["config"]), **CFG_SHRINK)
    return cfg, dict(work, traffic=dict(work["traffic"], **TRAFFIC_SHRINK))


def _traffic_module():
    return spec.traffic_module(spec.load_workload(NAME)["kind"])


def test_the_programs_representations_are_the_references():
    cfg, work = _cell()
    w = work["weights"]
    model = program.build(cfg, 5, w, "cpu")
    hist = _traffic_module().timed_histories(np.random.default_rng(0), 9, cfg["num_items"], work["traffic"])
    got = np.stack([u.user_embedding for u in model.user_representations(hist, [h.times for h in hist])])
    leaves = weights.tower_leaves(5, cfg, w, "cpu")
    rows = lambda ids: weights.table_rows(5, ids, cfg["num_items"], cfg["embedding_dim"], w, "cpu")
    want = towers.representations(cfg, leaves, rows, hist).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)  # unit vectors; sums in other orders


def test_timed_histories_keep_to_their_parameters():
    """The cell's own parameters: lengths log-normal about 68 within
    20-200, times nondecreasing from 1995-2015, gaps filling the buckets
    from 0 to past 60 (each history's causal pairs)."""
    p = spec.load_workload(NAME)["traffic"]
    hist = _traffic_module().timed_histories(np.random.default_rng(3), 2000, 26744, p)
    lens = np.array([len(h) for h in hist])
    assert lens.min() >= 20 and lens.max() <= 200 and 60 <= np.median(lens) <= 76
    assert 0.14 <= np.mean(lens == 200) <= 0.24
    assert all(len(h.times) == len(h) and all(np.diff(h.times) >= 0) for h in hist)
    starts = np.array([h.times[0] for h in hist])
    assert starts.min() >= p["time_start"][0] and starts.max() < p["time_start"][1]
    used = set()
    for h in hist[:200]:
        t = torch.tensor(h.times + h.times[-1:])
        used |= set(time_bucket(t[1:, None] - t[None, :-1]).tril().flatten().tolist())
    assert set(range(0, 61)) - {1} <= used  # bucket 1 holds no whole second (1.35-1.83 s)


def _run(fault=None, trace=False, seed=2718281829):
    cfg, work = _cell()
    return cell.run(NAME, seed, 0.3, trace, "cpu", 0.0, cfg=cfg, cell=work, fault=fault, log=lambda m: None)


def test_a_clean_run_is_correct_and_a_planted_fault_is_not():
    assert _run()["correct"] is True
    out = _run("answer")
    assert out["correct"] is False, out["checks"]


def test_the_traced_run_reads_the_new_metrics():
    """On the CPU no kernel runs, so the device readers (``hstu_attn_ms``,
    ``hstu_roofline``, ``topk_select_ms``) find nothing; the padding share
    reads the program's counter."""
    out = _run(trace=True)
    metrics = out["metrics"]
    assert {"mfu.hstu_batch", "prep_host_ms.hstu_batch", "budget_host_ms.hstu_batch", "pad_share.hstu_batch"} <= set(metrics)
    assert not {"hstu_attn_ms.hstu_batch", "hstu_roofline.hstu_batch", "topk_select_ms.hstu_batch"} & set(metrics)
    assert 0 < metrics["pad_share.hstu_batch"]["value"] < 100


def test_the_towers_operations_are_the_published_blocks():
    """At the published widths a position costs 8 x 25,000 operations and
    an attended key 8 x 200 (``flops.serve_batch`` sums both)."""
    cfg = spec.load_config(spec.load_benchmark(), "hstu-ml20m-large")
    family = spec.family_module("hstu")
    assert family.tower_flops(cfg, 3.0, 7.0) == 8 * (25_000 * 3 + 200 * 7)
    leaves = sum(int(np.prod(s)) for _, s, _, _ in family.tower_shapes(cfg))
    assert leaves == 200 * 50 + 8 * (50 * 200 + 50 * 50 + 50 + 399 + 129)


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
