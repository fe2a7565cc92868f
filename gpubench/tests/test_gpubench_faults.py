"""Each fault a cell can have, planted in the program under a run on the
CPU at a toy size (the look for a card skipped), must make ``correct``
false; the same run without it must not."""

import pytest

from gpubench import cell, spec

SHRINK = {
    "lstm32-items50m.serve-batch": ({"num_items": 140_000, "embedding_dim": 7},
                                     {"users_per_batch": 24, "pool_batches": 2, "check_users": 24}),
    "lstm32-items50m.recommend-1user": ({"num_items": 140_000, "embedding_dim": 7},
                                         {"pool_users": 40, "check_users": 12}),
}
FAULTS = {
    "lstm32-items50m.serve-batch": ["answer"],
    "lstm32-items50m.recommend-1user": ["answer"],
}


def run_small(name, fault=None, seed=31):
    bench = spec.load_benchmark()
    work = spec.load_workload(name)
    c, t = SHRINK[name]
    cfg = dict(spec.load_config(bench, work["config"]), **c)
    work = dict(work, traffic=dict(work["traffic"], **t))
    return cell.run(name, seed, 0.3, False, "cpu", 0.0, cfg=cfg, cell=work, fault=fault, log=lambda m: None)


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(FAULTS.items()) for f in fs])
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    out = run_small(name, fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_the_clean_run_is_correct(name):
    out = run_small(name)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
