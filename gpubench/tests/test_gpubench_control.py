"""The control on the card, at a size a test run holds: the plain
reference computed in TF32 (the precision below the configuration's) put
in the program's place must fail one of the cell's limits, while the
program's own run passes them all. (At the cells' own sizes the same
readings come from ``python3 gpubench/control.py``; PERF.md keeps them.)"""

import pytest

from gpubench import control, spec

SMALL = {
    "lstm32-items50m.serve-batch": ({"num_items": 4_000_000}, {"users_per_batch": 1024, "pool_batches": 2, "check_users": 512}),
    "lstm32-items50m.recommend-1user": ({"num_items": 4_000_000}, {"pool_users": 512, "check_users": 256}),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_and_the_program_passes(card, name):
    bench = spec.load_benchmark()
    work = spec.load_workload(name)
    c, t = SMALL[name]
    cfg = dict(spec.load_config(bench, work["config"]), **c)
    work = dict(work, traffic=dict(work["traffic"], **t))
    out = control.readings(name, 97, 2.0, control=True, device=card, cfg=cfg, cell=work)
    limits = work["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out
