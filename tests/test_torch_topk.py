"""The port's score + group-max against the JAX package's, on the CPU.

The same seeded numpy rows and representations go through
``score_groupmax_xla`` / ``score_submax_groupmax_xla`` and the Pallas
kernels in interpret mode, and through the port's plain versions and its
wrappers (which run the plain versions for CPU tensors). Row counts follow
``groupmax_rows``, the ``-inf`` positions must be identical, and values agree
to 1e-5 (f32 dots of order-1 scores, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbr_rs_tpu.ops import pallas_topk as ptk
from sbr_rs_tpu_torch.ops import topk_kernels as tk

ATOL = 1e-5
CC = 33
# (lo, c, n): a ragged whole catalog, and a ragged mid-catalog slab with
# lo + c < n (only the local-row bound masks its tail).
CASES = {"whole": (0, 5000, 5000), "mid": (4096, 3000, 100_000)}


def _mk(c, u, n, seed=0):
    """Chunk rows as the serving path builds them (rows past the catalog
    end repeat the last row) and order-1-score representations."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, CC)).astype(np.float32)
    rows = table[np.minimum(np.arange(c), n - 1)]
    reps = (rng.normal(size=(u, CC)) / np.sqrt(CC)).astype(np.float32)
    return rows, reps


def _pair(rows, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(rows).astype(jnp.bfloat16), torch.from_numpy(rows).to(torch.bfloat16)
    return jnp.asarray(rows), torch.from_numpy(rows)


def _assert_same(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(got[~np.isneginf(got)]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("u", [3, 8, 600])
@pytest.mark.parametrize("group", [8, 32, 128])
def test_plain_matches_xla(group, u, dtype):
    lo, c, n = 1024, 4096, 3000  # rows past n masked by global id
    rows, reps = _mk(c, u, n)
    jrows, trows = _pair(rows, dtype)
    want = ptk.score_groupmax_xla(jrows, jnp.asarray(reps), lo, n, group)
    got = tk.score_groupmax_plain(trows, torch.from_numpy(reps), lo, n, group)
    _assert_same(got, want)


@pytest.mark.parametrize("u", [3, 600])
@pytest.mark.parametrize("sub,group", [(8, 32), (32, 128)])
def test_submax_plain_matches_xla(sub, group, u):
    lo, c, n = 0, 4096, 3000
    rows, reps = _mk(c, u, n, seed=1)
    want = ptk.score_submax_groupmax_xla(jnp.asarray(rows), jnp.asarray(reps), lo, n, sub, group)
    got = tk.score_submax_groupmax_plain(
        torch.from_numpy(rows), torch.from_numpy(reps), lo, n, sub, group
    )
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("u", [3, 8, 600])
@pytest.mark.parametrize("group", [8, 32, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_score_groupmax_matches_pallas(case, group, u):
    lo, c, n = CASES[case]
    rows, reps = _mk(c, u, n, seed=2)
    want = ptk.score_groupmax(jnp.asarray(rows), jnp.asarray(reps), lo, n, group, interpret=True)
    got = tk.score_groupmax(torch.from_numpy(rows), torch.from_numpy(reps), lo, n, group)
    assert got.shape == (tk.groupmax_rows(c, group), u) == want.shape
    _assert_same(got, want)


@pytest.mark.parametrize(
    "case,sub,group,u,dtype",
    [
        ("whole", 32, 128, 600, "float32"),
        ("whole", 8, 32, 3, "float32"),
        ("mid", 32, 128, 8, "float32"),
        ("mid", 16, 64, 600, "float32"),
        ("whole", 32, 128, 8, "bfloat16"),
        ("mid", 8, 128, 3, "bfloat16"),
    ],
)
def test_score_submax_groupmax_matches_pallas(case, sub, group, u, dtype):
    lo, c, n = CASES[case]
    rows, reps = _mk(c, u, n, seed=3)
    jrows, trows = _pair(rows, dtype)
    want = ptk.score_submax_groupmax(jrows, jnp.asarray(reps), lo, n, sub, group, interpret=True)
    got = tk.score_submax_groupmax(trows, torch.from_numpy(reps), lo, n, sub, group)
    assert got[0].shape == (tk.groupmax_rows(c, sub), u)
    assert got[1].shape == (tk.groupmax_rows(c, group), u)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_shape_gate_and_row_count_match_jax():
    for args in [(2048, 33, 8, 48), (2048, 33, 8, 256), (2048, 1024, 8, 128),
                 (1024, 33, 8, 128), (131072, 128, 4096, 32)]:
        assert tk.groupmax_supported(*args) == ptk.groupmax_supported(*args)
    for c, group in [(1024, 128), (5000, 32), (10_000_000, 32), (2048, 8)]:
        assert tk.groupmax_rows(c, group) == ptk.groupmax_rows(c, group)
    with pytest.raises(ValueError):
        tk.score_groupmax(torch.zeros(16, 8), torch.zeros(2, 8), 0, 16, 48)
    with pytest.raises(ValueError):
        tk.score_submax_groupmax(torch.zeros(16, 8), torch.zeros(2, 8), 0, 16, 32, 32)


# -- score + rank count (the evaluation path's fused counter) -----------------

# (lo, col_lo, c, n): a whole catalog, and a mid-catalog slab with a ragged
# c (not a multiple of 128) and n cutting through it.
COUNT_CASES = {"whole": (0, 0, 5000, 5000), "mid": (4096, 100, 3001, 6000)}


def _count_inputs(case, u, dtype, seed=4):
    """Rows, representations, probes (some outside [0, c): they clamp) and
    targets that sit between two neighbouring f64 scores of the rows as
    stored (bf16 rows rounded), at least 1e-4 from every row score, so that
    the two formulations' f32 rounding cannot move a count. A few users get
    the mask value f32 min (every valid row counts) or +inf (none does)."""
    lo, col_lo, c, n = COUNT_CASES[case]
    rows, reps = _mk(c, u, max(n, lo + c), seed=seed)
    rng = np.random.default_rng(seed + 100)
    stored = _pair(rows, dtype)[1].to(torch.float64).numpy()
    scores = np.sort(stored @ reps.astype(np.float64).T, axis=0)  # [c, u]
    gaps = np.diff(scores, axis=0)
    targets = np.empty(u, np.float32)
    for j in range(u):
        wide = np.flatnonzero(gaps[:, j] > 2e-4)
        i = wide[rng.integers(len(wide))]
        targets[j] = (scores[i, j] + scores[i + 1, j]) / 2
    targets[::7] = np.finfo(np.float32).min
    targets[3::7] = np.inf
    probe = rng.integers(-3, c + 3, u).astype(np.int32)
    return (lo, col_lo, n), rows, reps, targets, probe


@pytest.mark.parametrize(
    "case,u,dtype",
    [
        ("whole", 600, "float32"),
        ("whole", 13, "float32"),
        ("mid", 600, "float32"),
        ("mid", 3, "float32"),
        ("whole", 13, "bfloat16"),
        ("mid", 600, "bfloat16"),
    ],
)
def test_score_count_ge_matches_pallas(case, u, dtype):
    (lo, col_lo, n), rows, reps, targets, probe = _count_inputs(case, u, dtype)
    jrows, trows = _pair(rows, dtype)
    want_c, want_p = ptk.score_count_ge(
        jrows, jnp.asarray(reps), jnp.asarray(targets), jnp.asarray(probe), lo, col_lo, n,
        interpret=True,
    )
    got_c, got_p = tk.score_count_ge(
        trows, torch.from_numpy(reps), torch.from_numpy(targets),
        torch.from_numpy(probe.astype(np.int64)), lo, col_lo, n,
    )
    assert got_c.dtype == torch.int32 and got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=0)
    # The plain formulation directly, and the ends of the count range.
    plain_c, _ = tk.score_count_ge_plain(
        trows, torch.from_numpy(reps), torch.from_numpy(targets), torch.from_numpy(probe), lo, col_lo, n
    )
    assert torch.equal(plain_c, got_c)
    valid_rows = min(rows.shape[0], n - lo) - col_lo
    assert (got_c.numpy()[::7] == valid_rows).all()
    assert (got_c.numpy()[3::7] == 0).all()


def test_score_count_ge_gate_and_devices():
    assert tk.count_supported(10_000_000, 128, 4096) == ptk.count_supported(10_000_000, 128, 4096)
    assert not tk.count_supported(100, 513, 4) and not ptk.count_supported(100, 513, 4)
    args = (torch.zeros(4), torch.zeros(4, dtype=torch.int64), 0, 0, 16)
    with pytest.raises(ValueError):
        tk.score_count_ge(torch.zeros(16, 513), torch.zeros(4, 513), *args)
    meta = torch.empty((16, 9), device="meta")
    with pytest.raises(ValueError):
        tk.score_count_ge(meta, torch.empty((4, 9), device="meta"), *args)
    counts, probe = tk.score_count_ge(torch.zeros(0, 9), torch.zeros(4, 9), *args)
    assert counts.tolist() == [0] * 4 and probe.tolist() == [0.0] * 4
    tk.score_count_ge.launches = 0
    tk.score_count_ge(torch.ones(16, 9), torch.ones(4, 9), *args)
    assert tk.score_count_ge.launches == 0
