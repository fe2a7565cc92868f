"""The plain versions of the port's row kernels against the Pallas probes
they replace, on the CPU (the probes in TPU interpret mode):

* P1 ``scripts/row_pipeline_probe.py pl_gather`` -- ``gather_rows``;
* P2 ``row_pipeline_probe.py pl_rmw`` -- ``scatter_add_rows_``;
* P3 ``scripts/cand_gather_probe.py _make_vmem`` and P4 ``pallas_dma_rows``
  -- ``cand_score`` (and ``xla_baseline``, the probe's own reference).

The probes are imported from ``scripts/`` as files, never edited. P3/P4
read their shapes from module globals, which the tests shrink with
``monkeypatch`` (BT = 256 positions, N = 64 rows). Gathers and
read-modify-writes are exact; candidate scores sum 128 products in another
order, so they agree within 1e-5 of the largest score.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbr_rs_tpu_torch.ops import row_kernels
from sbr_rs_tpu_torch.utils.convert import params_from_numpy

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
DTYPES = [np.float32, ml_dtypes.bfloat16]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def row_probe():
    return _load("row_pipeline_probe")


@pytest.fixture
def cand_probe(monkeypatch):
    mod = _load("cand_gather_probe")
    for name, value in (("B", 8), ("T", 32), ("BT", 256), ("N", 64)):
        monkeypatch.setattr(mod, name, value)
    return mod


def _table(rng, n, c, dtype):
    """The same table as a numpy array and as a port tensor."""
    a = rng.normal(size=(n, c)).astype(dtype)
    return a, params_from_numpy({"item_table": a, "tower": {}}, "cpu")["item_table"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_rows_matches_pl_gather(row_probe, dtype):
    rng = np.random.default_rng(0)
    a, table = _table(rng, 40, 128, dtype)
    idx = np.sort(rng.choice(40, 24, replace=False)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(row_probe.pl_gather(jnp.asarray(a), jnp.asarray(idx))).astype(np.float32)
    got = row_kernels.gather_rows(table, torch.from_numpy(idx).long())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Out-of-range ids clamp to the first and last rows (mode="clip").
    clipped = row_kernels.gather_rows(table, torch.tensor([-3, 40, 99]))
    np.testing.assert_array_equal(clipped.numpy(), a[[0, 39, 39]].astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_add_rows_matches_pl_rmw(row_probe, dtype):
    rng = np.random.default_rng(1)
    n = 40
    a, table = _table(rng, n, 128, dtype)
    idx = np.sort(rng.choice(n, 16, replace=False)).astype(np.int32)
    g = (rng.normal(size=(16, 128)) * 0.1).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(row_probe.pl_rmw(jnp.asarray(a), jnp.asarray(idx), jnp.asarray(g)))
    # The port's layout: the same rows with the dropped sentinel N
    # interleaved (as dedupe_and_sum emits it), and deltas there that would
    # show if they landed anywhere.
    slots = np.full(32, n, dtype=np.int64)
    slots[1::2] = idx
    delta = np.full((32, 128), 7.0, dtype=np.float32).astype(dtype)
    delta[1::2] = g
    d = params_from_numpy({"item_table": delta, "tower": {}}, "cpu")["item_table"]
    out = row_kernels.scatter_add_rows_(table, torch.from_numpy(slots), d)
    assert out is table
    np.testing.assert_array_equal(
        table.to(torch.float32).numpy(), np.asarray(want).astype(np.float32)
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_cand_score_matches_pl_vmem(cand_probe, dtype):
    rng = np.random.default_rng(2)
    a, table = _table(rng, cand_probe.N, cand_probe.C, dtype)
    haug = rng.normal(size=(cand_probe.BT, cand_probe.C)).astype(np.float32)
    cand = rng.integers(0, cand_probe.N, (cand_probe.BT, cand_probe.K)).astype(np.int32)
    args = (jnp.asarray(a), jnp.asarray(haug), jnp.asarray(cand))
    with pltpu.force_tpu_interpret_mode():
        wants = [
            np.asarray(cand_probe._make_vmem(kernel)(*args))
            for kernel in (cand_probe._vmem_kernel, cand_probe._vmem_kernel_unroll)
        ]
    wants.append(np.asarray(cand_probe.xla_baseline(*args)))
    assert row_kernels.cand_score_fits_smem(table)
    got = row_kernels.cand_score(torch.from_numpy(haug), table, torch.from_numpy(cand).long())
    assert got.shape == (cand_probe.BT, cand_probe.K) and got.dtype == torch.float32
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_cand_score_matches_pl_dma_rows(cand_probe):
    # The probe's row scratch is f32, so P4's probe takes f32 tables only.
    rng = np.random.default_rng(3)
    a, table = _table(rng, cand_probe.N, cand_probe.C, np.float32)
    haug = rng.normal(size=(cand_probe.BT, cand_probe.C)).astype(np.float32)
    cand = rng.integers(0, cand_probe.N, (cand_probe.BT, cand_probe.K)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(cand_probe.pallas_dma_rows(jnp.asarray(a), jnp.asarray(haug), jnp.asarray(cand)))
    got = row_kernels.cand_score_rows(torch.from_numpy(haug), table, torch.from_numpy(cand).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_cand_score_routes_by_table_size(dtype):
    """P3 exactly while the table fits one block's shared memory, P4
    beyond; both routes compute the plain version's scores."""
    itemsize = np.dtype(dtype).itemsize
    fits = row_kernels.SMEM_BYTES // (33 * itemsize)
    rng = np.random.default_rng(4)
    haug = torch.from_numpy(rng.normal(size=(10, 33)).astype(np.float32))
    for n, want_fit in ((fits, True), (fits + 1, False)):
        _, table = _table(rng, n, 33, dtype)
        assert row_kernels.cand_score_fits_smem(table) is want_fit
        cand = torch.from_numpy(rng.integers(0, n, (10, 5)))
        want = row_kernels.cand_score_plain(haug, table, cand)
        for fn in (row_kernels.cand_score, row_kernels.cand_score_rows):
            assert torch.equal(fn(haug, table, cand), want)
    assert row_kernels.cand_score_fits_smem(torch.empty((1682, 33)))  # fit-bench: P3
    assert not row_kernels.cand_score_fits_smem(torch.empty((1688, 128)))  # the probe's table: P4
