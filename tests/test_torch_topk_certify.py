"""The certificate of the port's single-pass top-k, on the CPU.

On the card phase 1 of ``topk_streamed`` scores in 3xTF32, within
``phase1_error_bound`` of the FP32 scores phase 2 recomputes, and every
user's result is certified against that bound or run again in FP32
(``score_submax_groupmax_fp32``). The kernels cannot run here, so these
tests replace phase 1 by its plain version plus seeded noise bounded by a
stated ``eps`` (monkeypatched into ``models/base.py``) and hold the served
lists to the JAX package's ``recommend_batch`` on the same weights: values
within 1e-5, ids equal except where two of the reference's scores tie
within 1e-6. They also check which users the certificate sends back, the
bound the CPU uses (FP32: the plain phase 1 and phase 2), and that serving
and evaluation leave the caller's ``allow_tf32`` as they found it while
phase 2 runs with it off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu.models.base import ImplicitSequenceModel as JaxModel
from sbr_rs_tpu_torch import datasets, evaluation
from sbr_rs_tpu_torch.models import base, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.ops import topk_kernels as tk

ATOL = 1e-5
TIE = 1e-6
N = 5000
CHUNK = 2048  # three chunks: the single-pass merge, group 128, sub 32
SEQ_LEN = 8
DIM = 16
K = 6


@pytest.fixture
def small_chunks(monkeypatch):
    JaxModel._TOPK_FN_CACHE.clear()
    monkeypatch.setattr(JaxModel, "_SERVE_ITEM_CHUNK", CHUNK)
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", CHUNK)
    monkeypatch.setattr(base.topk_streamed, "rechecked_users", 0)
    yield
    JaxModel._TOPK_FN_CACHE.clear()


def _models(seed, twins=0):
    """A JAX model and the port's on the same weights, with random biases;
    ``twins`` rows copy other rows, so that their scores tie exactly."""
    jm = jax_lstm.Hyperparameters(N, SEQ_LEN).embedding_dim(DIM).from_seed(seed).build()
    tree = {
        "item_table": np.array(jm._params["item_table"]),
        "tower": {k: np.array(v) for k, v in jm._params["tower"].items()},
    }
    rng = np.random.default_rng(seed)
    tree["item_table"][:, -1] = rng.normal(size=N) * 0.1
    if twins:
        src, dst = rng.choice(N, size=(2, twins), replace=False)
        tree["item_table"][dst] = tree["item_table"][src]
    tree["tower"]["b"] = (rng.normal(size=tree["tower"]["b"].shape) * 0.1).astype(np.float32)
    jm._params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = lstm.Hyperparameters.from_dict(jm.hyper.to_dict()).build(torch.device("cpu"))
    pm.load_numpy_params(tree)
    return jm, pm


def _histories(seed, users=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N, rng.integers(1, 16)).tolist() for _ in range(users)]


def _assert_topk_equal(got, want):
    (gi, gv), (wi, wv) = got, want
    gi, wi = np.asarray(gi), np.asarray(wi)
    assert gi.shape == wi.shape and gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=0)
    gaps = np.abs(np.diff(wv, axis=1)) <= TIE
    tied = np.zeros(wv.shape, bool)
    tied[:, :-1] |= gaps
    tied[:, 1:] |= gaps
    np.testing.assert_array_equal(gi[~tied], wi[~tied])
    for row in gi:
        assert len(set(row.tolist())) == len(row)


def _noisy_phase1(eps, seed):
    """A phase 1 whose scores are the plain FP32 ones plus noise drawn
    uniformly from (-eps_u, eps_u): what the bound allows a kernel."""
    rng = np.random.default_rng(seed)

    def phase1(rows, reps_aug, lo, n, sub, group):
        c, u = rows.shape[0], reps_aug.shape[0]
        st = rows.to(torch.float32) @ reps_aug.T
        noise = torch.from_numpy(rng.uniform(-1, 1, st.shape).astype(np.float32))
        st = st + 0.999 * noise * eps(rows, reps_aug)[None, :]
        st.masked_fill_((lo + torch.arange(c) >= n)[:, None], float("-inf"))
        rows_out = tk.groupmax_rows(c, sub) * sub
        st = torch.cat([st, st.new_full((rows_out - c, u), float("-inf"))])
        smax = st.reshape(-1, sub, u).amax(dim=1)
        return smax, smax.reshape(-1, group // sub, u).amax(dim=1)

    return phase1


@pytest.mark.parametrize("size", ["tiny", "gap", "spread"])
@pytest.mark.parametrize("twins", [0, 400])
def test_exact_despite_noisy_phase1(size, twins, small_chunks, monkeypatch):
    """Phase 1 off by up to eps: eps 1e-4 of the scores' spread (every
    user certified), near the median gap between a user's k-th value and its
    threshold (users on both sides), or the whole spread (none certified);
    with and without exact twins crowding the threshold. Every user's list
    equals the JAX package's."""
    jm, pm = _models(seed=11, twins=twins)
    hs = _histories(seed=12)
    table = pm._params["item_table"]
    kk = K + max(len(h) for h in hs)  # the seen rows' width
    scores, v_k = _scores_and_kth(pm, hs)
    gaps = v_k - _theta(scores, 32, 128, kk)
    spread = float(scores.std())
    e = {"tiny": 1e-4 * spread, "gap": 0.85 * float(np.median(gaps)), "spread": spread}[size]

    def eps(rows, reps_aug):
        return torch.full((reps_aug.shape[0],), e)

    monkeypatch.setattr(base, "score_submax_groupmax", _noisy_phase1(eps, seed=13))
    monkeypatch.setattr(base, "phase1_error_bound", eps)
    got = pm.recommend_batch(hs, k=K, return_scores=True)
    _assert_topk_equal(got, jm.recommend_batch(hs, k=K, return_scores=True))
    rechecked = base.topk_streamed.rechecked_users
    assert table is pm._params["item_table"]
    if size == "spread":
        assert rechecked == len(hs)  # nothing can be certified
    elif size == "tiny":
        assert rechecked == 0
    else:
        assert 0 < rechecked < len(hs)


def _scores_and_kth(pm, hs):
    """The exact scores ``[n, U]`` (float64) of the port's model for the
    histories, and each user's k-th largest unseen score."""
    reps = pm._representations(*base._flatten(hs))
    reps_aug = torch.cat([reps, torch.ones((len(hs), 1))], dim=1)
    scores = pm._params["item_table"].double().numpy() @ reps_aug.double().numpy().T
    masked = scores.copy()
    for u, h in enumerate(hs):
        masked[list(set(h)), u] = -np.inf
    return scores, -np.sort(-masked, axis=0)[K - 1]


def _theta(scores, sub, group, kk):
    """The certificate's threshold per user from the scores ``[n, U]``
    (numpy, float64): the w1-th largest group maximum, the kk-th largest
    subgroup maximum of the winning groups, each -inf where everything is
    selected, and the larger of the two."""
    n, u = scores.shape
    rows = -(-n // 2048) * 2048
    s = np.concatenate([scores, np.full((rows - n, u), -np.inf)])
    smax = s.reshape(-1, sub, u).max(axis=1)
    gmax = s.reshape(-1, group, u).max(axis=1)
    r = group // sub
    theta = np.full(u, -np.inf)
    for j in range(u):
        order = np.argsort(-gmax[:, j], kind="stable")
        w1 = min(kk, len(order))
        theta_g = gmax[order[w1 - 1], j] if w1 < len(order) else -np.inf
        svals = np.sort(smax[(order[:w1, None] * r + np.arange(r)).ravel(), j])[::-1]
        w = min(kk, len(svals))
        theta_s = svals[w - 1] if w < len(svals) else -np.inf
        theta[j] = max(theta_g, theta_s)
    return theta


@pytest.mark.parametrize("seen_width,twins", [(0, 0), (1, 1000)])
def test_certificate_sends_back_the_users_it_cannot_certify(seen_width, twins, small_chunks, monkeypatch):
    """kk = k + seen width. With no seen list kk = k, so a user's k-th
    value meets the k-th subgroup maximum and only a user whose k-th item
    shares a subgroup with a better one can pass; with one (padding) seen
    id the users whose k-th item has an exact twin fail. Exactly the users
    a numpy recomputation of the certificate rejects go back to the FP32
    phase 1, and the values stay exact."""
    _, pm = _models(seed=21, twins=twins)
    hs = _histories(seed=22)
    reps = pm._representations(*base._flatten(hs))
    table = pm._params["item_table"]
    seen = torch.full((len(hs), seen_width), N, dtype=torch.int64)
    sent = []

    def fp32_spy(rows, reps_aug, lo, n, sub, group):
        sent.append(reps_aug.clone())
        return tk.score_submax_groupmax_fp32(rows, reps_aug, lo, n, sub, group)

    monkeypatch.setattr(base, "score_submax_groupmax_fp32", fp32_spy)
    vals, _ = base.topk_streamed(
        table, reps, seen, K, serve_chunk=CHUNK, group_target=128, sub_target=32,
        merge_buffer_bytes=6 << 30, submax_buffer_bytes=6 << 30, phase2_buffer_bytes=1 << 30,
    )
    reps_aug = torch.cat([reps, torch.ones((len(hs), 1))], dim=1)
    scores = table.double().numpy() @ reps_aug.double().numpy().T
    theta = _theta(scores, 32, 128, K + seen_width)
    eps = tk.phase1_error_bound(table, reps_aug).double().numpy()
    want_vals = -np.sort(-scores, axis=0)[:K].T
    np.testing.assert_allclose(vals.numpy(), want_vals, atol=ATOL, rtol=0)
    expected = np.flatnonzero(~(want_vals[:, -1] >= theta + eps))
    assert len(expected) > 0 and (twins == 0 or len(expected) < len(hs))
    assert base.topk_streamed.rechecked_users == len(expected)
    assert len(sent) == 1 and torch.equal(sent[0], reps_aug[expected])


def test_huge_eps_rechecks_everyone(small_chunks, monkeypatch):
    jm, pm = _models(seed=31)
    hs = _histories(seed=32)
    monkeypatch.setattr(base, "phase1_error_bound", lambda table, reps_aug: torch.full((reps_aug.shape[0],), 1e6))
    got = pm.recommend_batch(hs, k=K, return_scores=True)
    assert base.topk_streamed.rechecked_users == len(hs)
    _assert_topk_equal(got, jm.recommend_batch(hs, k=K, return_scores=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_bound_is_fp32_and_covers_the_plain_scores(dtype):
    """On the CPU phase 1 is the plain FP32 version, so eps is two FP32
    dots' bound: 2 gamma_cc sum_k |reps_k| max_i |rows_ik|; the plain
    maxima and the FP32 recomputation lie within it."""
    rng = np.random.default_rng(41)
    cc = 33
    rows = torch.from_numpy(rng.normal(size=(3000, cc)).astype(np.float32)).to(dtype)
    reps = torch.from_numpy((rng.normal(size=(7, cc)) / cc**0.5).astype(np.float32))
    eps = tk.phase1_error_bound(rows, reps)
    m = np.abs(rows.float().numpy()).max(axis=0).astype(np.float64)
    want = 2 * tk._gamma_fp32(cc) * (np.abs(reps.numpy()).astype(np.float64) @ m)
    assert eps.dtype == torch.float32 and eps.shape == (7,)
    assert (eps.double().numpy() >= want).all()
    np.testing.assert_allclose(eps.numpy(), want, rtol=1e-6)
    assert tk.phase1_gamma(cc, dtype, tensor_cores=False) == 2 * tk._gamma_fp32(cc)
    smax, gmax = tk.score_submax_groupmax_fp32(rows, reps, 0, 3000, 32, 128)
    ps, pg = tk.score_submax_groupmax(rows, reps, 0, 3000, 32, 128)
    assert torch.equal(smax, ps) and torch.equal(gmax, pg)
    exact = rows.double() @ reps.double().T
    want_max = exact[: 93 * 32].reshape(93, 32, 7).amax(dim=1)  # the whole subgroups
    assert ((ps[:93] - want_max).abs() <= eps.double()).all()


def test_serving_and_evaluation_keep_the_callers_tf32_flag(small_chunks, monkeypatch):
    """The model never sets allow_tf32 for the process: building, serving
    and evaluating with the caller's True leave it True, while phase 2's
    bmm runs with it False."""
    saved = torch.backends.cuda.matmul.allow_tf32
    seen_flags = []
    bmm = torch.bmm

    def spy(*args, **kwargs):
        seen_flags.append(torch.backends.cuda.matmul.allow_tf32)
        return bmm(*args, **kwargs)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        jm, pm = _models(seed=51)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        monkeypatch.setattr(torch, "bmm", spy)
        hs = _histories(seed=52, users=8)
        got = pm.recommend_batch(hs, k=K, return_scores=True)
        assert seen_flags and not any(seen_flags)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        _assert_topk_equal(got, jm.recommend_batch(hs, k=K, return_scores=True))
        test = datasets.synthetic_interactions(30, N, 8, rng=53).to_compressed()
        mrr = evaluation.mrr_score(pm, test)
        assert np.isfinite(mrr) and torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
