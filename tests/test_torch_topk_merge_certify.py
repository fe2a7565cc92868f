"""The certificate of the port's group-only top-k routes, on the CPU.

The running merge (one catalog chunk a call) and the group-only single
pass score phase 1 on the card with the 3xTF32 K3 (``score_groupmax``),
within ``phase1_error_bound`` of the FP32 scores phase 2 recomputes. They
keep ``kk + 1`` groups; the last kept maximum, ``theta``, bounds everything
left out, and a user whose k-th phase-2 value is not above ``theta + eps``
runs phase 1 again with the FP32 K3 (``score_groupmax_fp32``). The kernels
cannot run here, so these tests replace phase 1 by its plain version plus
seeded noise bounded by a stated ``eps`` (monkeypatched into
``models/base.py``, with ``phase1_error_bound`` set to that eps) and hold
the served lists to the JAX package's ``recommend_batch`` on the same
weights and budgets, its Pallas K3 in interpret mode: values within 1e-5,
ids equal except where two of the reference's scores tie within 1e-6. They
also check which users go back to the FP32 K3, and ``theta`` against a
brute-force maximum over the groups left out. The selection of the top
groups in two levels (``_top_groups``: super-group maxima, their top kk,
then the top kk of the groups they hold) is held to brute force on
synthetic group maxima, and the single pass with subgroups that takes it
to the JAX package's dense lists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu.models.base import ImplicitSequenceModel as JaxModel
from sbr_rs_tpu_torch.models import base, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel
from sbr_rs_tpu_torch.ops import topk_kernels as tk

ATOL = 1e-5
TIE = 1e-6
N = 5000
CHUNK = 2048  # three chunks; group 128 (16 groups a chunk)
GROUP = 128
SEQ_LEN = 8
DIM = 16
K = 6
# The budgets that select each group-only route, on both packages: the
# running merge (merge budget 0), and the single pass without subgroup
# refinement (no subgroup stack fits).
ROUTES = {
    "merge": {"_MERGE_BUFFER_BYTES": 0},
    "group_single_pass": {"_SUBMAX_BUFFER_BYTES": 0},
}


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    JaxModel._TOPK_FN_CACHE.clear()
    for name, value in {"_SERVE_ITEM_CHUNK": CHUNK, **ROUTES[request.param]}.items():
        monkeypatch.setattr(JaxModel, name, value)
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    monkeypatch.setattr(base.topk_streamed, "rechecked_users", 0)
    monkeypatch.setenv("SBR_PALLAS_TOPK", "1")  # the JAX side on its Pallas K3
    yield request.param
    JaxModel._TOPK_FN_CACHE.clear()


def _budgets(route):
    patch = ROUTES[route]
    return {
        "merge_buffer_bytes": patch.get("_MERGE_BUFFER_BYTES", 6 << 30),
        "submax_buffer_bytes": patch.get("_SUBMAX_BUFFER_BYTES", 6 << 30),
    }


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


def _reference(jm, hs):
    with pltpu.force_tpu_interpret_mode():
        return jm.recommend_batch(hs, k=K, return_scores=True)


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


def _noisy_groupmax(eps, seed):
    """A K3 whose scores are the plain FP32 ones plus noise drawn uniformly
    from (-eps_u, eps_u): what the bound allows the kernel."""
    rng = np.random.default_rng(seed)

    def score_groupmax(rows, reps_aug, lo, n, group, split=None):
        assert split is None  # CPU tensors need no split
        c, u = rows.shape[0], reps_aug.shape[0]
        st = rows.to(torch.float32) @ reps_aug.T
        noise = torch.from_numpy(rng.uniform(-1, 1, st.shape).astype(np.float32))
        st = st + 0.999 * noise * eps(rows, reps_aug)[None, :]
        st.masked_fill_((lo + torch.arange(c) >= n)[:, None], float("-inf"))
        rows_out = tk.groupmax_rows(c, group) * group
        st = torch.cat([st, st.new_full((rows_out - c, u), float("-inf"))])
        return st.reshape(-1, group, u).amax(dim=1)

    return score_groupmax


def _exact_scores(pm, hs):
    """The exact scores ``[n, U]`` (float64) of the port's model for the
    histories, each user's k-th largest unseen score, and ``reps_aug``."""
    reps = pm._representations(*base._flatten(hs))
    reps_aug = torch.cat([reps, torch.ones((len(hs), 1))], dim=1)
    scores = pm._params["item_table"].double().numpy() @ reps_aug.double().numpy().T
    masked = scores.copy()
    for u, h in enumerate(hs):
        masked[list(set(h)), u] = -np.inf
    return scores, -np.sort(-masked, axis=0)[K - 1], reps, reps_aug


def _theta(scores, kk):
    """The certificate's threshold per user from the scores ``[n, U]``
    (numpy): the (kk+1)-th largest maximum over groups of GROUP rows
    (-inf when there are at most kk groups)."""
    n, u = scores.shape
    rows = -(-n // GROUP) * GROUP
    gmax = np.concatenate([scores, np.full((rows - n, u), -np.inf)]).reshape(-1, GROUP, u).max(axis=1)
    if gmax.shape[0] <= kk:
        return np.full(u, -np.inf)
    return -np.sort(-gmax, axis=0)[kk]


@pytest.mark.parametrize("size", ["tiny", "gap", "spread"])
@pytest.mark.parametrize("twins", [0, 400])
def test_exact_despite_noisy_phase1(size, twins, route, monkeypatch):
    """Phase 1 off by up to eps: eps 1e-4 of the scores' spread (every
    user certified), near the median gap between a user's k-th value and its
    threshold (users on both sides), or the whole spread (none certified);
    with and without exact twins crowding the threshold. Every user's list
    equals the JAX package's."""
    jm, pm = _models(seed=11, twins=twins)
    hs = _histories(seed=12)
    kk = K + max(len(h) for h in hs)  # the seen rows' width
    scores, v_k, _, _ = _exact_scores(pm, hs)
    gaps = v_k - _theta(scores, kk)
    spread = float(scores.std())
    e = {"tiny": 1e-4 * spread, "gap": 0.85 * float(np.median(gaps)), "spread": spread}[size]

    def eps(rows, reps_aug):
        return torch.full((reps_aug.shape[0],), e)

    monkeypatch.setattr(base, "score_groupmax", _noisy_groupmax(eps, seed=13))
    monkeypatch.setattr(base, "phase1_error_bound", eps)
    got = pm.recommend_batch(hs, k=K, return_scores=True)
    _assert_topk_equal(got, _reference(jm, hs))
    rechecked = base.topk_streamed.rechecked_users
    if size == "spread":
        assert rechecked == len(hs)  # nothing can be certified
    elif size == "tiny":
        assert rechecked == 0
    else:
        assert 0 < rechecked < len(hs)


@pytest.mark.parametrize("twins", [0, 1000])
def test_certificate_sends_back_the_users_it_cannot_certify(twins, route, monkeypatch):
    """No seen list, so kk = k and theta is the (k+1)-th group maximum: a
    user whose k-th item has an exact twin in another group cannot be
    certified. Exactly the users a numpy recomputation of the certificate
    rejects go to the FP32 K3, in every chunk call, and the values stay
    exact."""
    _, pm = _models(seed=21, twins=twins)
    hs = _histories(seed=22)
    table = pm._params["item_table"]
    scores, _, reps, reps_aug = _exact_scores(pm, hs)
    seen = torch.full((len(hs), 0), N, dtype=torch.int64)
    sent = []

    def fp32_spy(rows, reps_r, lo, n, group):
        sent.append(reps_r.clone())
        return tk.score_groupmax_fp32(rows, reps_r, lo, n, group)

    monkeypatch.setattr(base, "score_groupmax_fp32", fp32_spy)
    vals, _ = base.topk_streamed(
        table, reps, seen, K, serve_chunk=CHUNK, group_target=GROUP, sub_target=32,
        phase2_buffer_bytes=1 << 30, **_budgets(route),
    )
    theta = _theta(scores, K)
    eps = tk.phase1_error_bound(table, reps_aug).double().numpy()
    want_vals = -np.sort(-scores, axis=0)[:K].T
    np.testing.assert_allclose(vals.numpy(), want_vals, atol=ATOL, rtol=0)
    expected = np.flatnonzero(~(want_vals[:, -1] >= theta + eps))
    if twins:
        assert 0 < len(expected) < len(hs)
    assert base.topk_streamed.rechecked_users == len(expected)
    calls = (-(-N // CHUNK) if route == "merge" else 1) if len(expected) else 0
    assert len(sent) == calls
    assert all(torch.equal(s, reps_aug[expected]) for s in sent)


def test_huge_eps_rechecks_everyone(route, monkeypatch):
    jm, pm = _models(seed=31)
    hs = _histories(seed=32)
    monkeypatch.setattr(base, "phase1_error_bound", lambda table, reps_aug: torch.full((reps_aug.shape[0],), 1e6))
    got = pm.recommend_batch(hs, k=K, return_scores=True)
    assert base.topk_streamed.rechecked_users == len(hs)
    _assert_topk_equal(got, _reference(jm, hs))


@pytest.mark.parametrize("n,kk,boost", [(N, 6, False), (N, 6, True), (N, 21, False), (2100, 40, False)])
@pytest.mark.parametrize("single_pass", [False, True])
def test_theta_is_the_largest_maximum_left_out(n, kk, boost, single_pass):
    """``_group_winners`` keeps the top kk groups, and theta equals the
    largest group maximum outside them, brute force over every group;
    with the first chunk's rows scaled up (``boost``) its groups hold the
    top kk + 1, so the merge must keep kk + 1 from a chunk; with 17 real
    groups (2100 rows) and kk = 40, every group is kept and theta is
    -inf."""
    _, pm = _models(seed=41, twins=300)
    table = pm._params["item_table"][:n].clone()
    if boost:
        table[:CHUNK] *= 4
    hs = _histories(seed=42, users=9)
    reps_aug = torch.cat([pm._representations(*base._flatten(hs)), torch.ones((len(hs), 1))], dim=1)

    def score(rows, lo):
        return tk.score_groupmax(rows, reps_aug, lo, n, GROUP)

    gids, theta = base._group_winners(
        table, kk, len(hs), score, serve_chunk=CHUNK, group=GROUP, single_pass=single_pass
    )
    # Every group maximum, by global group id, from the same calls.
    if single_pass:
        gmax = score(table, 0)
    else:
        gmax = torch.cat([score(table[lo : lo + CHUNK], lo)[: CHUNK // GROUP] for lo in range(0, n, CHUNK)])
    assert gids.shape == (len(hs), min(kk, gmax.shape[0]) if single_pass else kk)
    for u in range(len(hs)):
        kept = set(gids[u].tolist())
        assert len(kept) == gids.shape[1]
        left = [g for g in range(gmax.shape[0]) if g not in kept]
        want = max((float(gmax[g, u]) for g in left), default=float("-inf"))
        assert float(theta[u]) == want
        kept_vals = [float(gmax[g, u]) for g in kept if g < gmax.shape[0]]
        assert min(kept_vals, default=float("-inf")) >= want
    if -(-n // GROUP) <= kk:
        assert torch.isneginf(theta).all()


def _group_maxima(case):
    """Synthetic group maxima ``[G, U]`` (f32, from a seed) for
    ``test_top_groups_keeps_the_top_groups``: distinct values; or ties
    among each user's three largest and among its 50 smallest, far from the
    kk-th value; or the largest in the tail past the last whole
    super-group; or ``-inf`` groups at the end, as groups past the catalog
    give; or only five groups above ``-inf``."""
    g, u, kind = case
    gm = torch.from_numpy(np.random.default_rng(g * 7 + u).normal(size=(g, u)).astype(np.float32))
    order = torch.argsort(gm, dim=0, descending=True)
    cols = torch.arange(u)
    if kind == "ties":
        for a, b in ((0, 3), (g - 50, g)):
            gm[order[a:b], cols] = gm[order[a], cols]
    elif kind == "top_in_the_tail":
        gm[-(g % 128) :] += 3
    elif kind == "neg_inf":
        gm[-500:] = float("-inf")
    elif kind == "few_finite":
        gm[5:] = float("-inf")
    return gm


# (groups G, users U, kind): G a multiple of the super-group width or not,
# fewer super-groups than kk (one level), fewer groups than kk, one user.
TOP_GROUP_CASES = {
    "tail": (6437, 5, "distinct"),
    "whole_blocks": (128 * 30, 4, "distinct"),
    "few_super_groups": (128 * 8 + 5, 4, "distinct"),
    "few_groups": (7, 4, "distinct"),
    "one_user": (6437, 1, "distinct"),
    "top_in_the_tail": (6437, 5, "top_in_the_tail"),
    "neg_inf_past_the_catalog": (6437, 5, "neg_inf"),
    "few_finite": (6437, 3, "few_finite"),
    "ties_away_from_kk": (6437, 5, "ties"),
}


@pytest.mark.parametrize("name", sorted(TOP_GROUP_CASES))
@pytest.mark.parametrize("kk", [10, 21])
def test_top_groups_keeps_the_top_groups(name, kk, monkeypatch):
    """``_top_groups`` against brute force for each user: ``kk + 1`` kept
    as ``_group_winners`` keeps them, then the first ``kk`` are the top kk
    groups (the same set wherever the kk-th value is not tied), and the
    (kk+1)-th value is bit for bit the largest maximum left out (``-inf``
    when every group is kept); ``kk`` kept as ``_submax_winners`` keeps
    them gives the same values, its last the kk-th largest. The floor on
    the maxima a two-level selection takes is lifted, so that these small
    stacks take it wherever they hold more super-groups than kk + 1."""
    monkeypatch.setattr(base, "TWO_LEVEL_MIN_MAXIMA", 0)
    gm = _group_maxima(TOP_GROUP_CASES[name])
    g, u = gm.shape
    assert (g // base.SUPER_GROUP > kk + 1) == (name in ("tail", "whole_blocks", "one_user", "neg_inf_past_the_catalog",
                                                         "few_finite", "ties_away_from_kk", "top_in_the_tail"))
    vals, ids = base._top_groups(gm, kk + 1)
    v1, i1 = base._top_groups(gm, kk)
    assert vals.shape == ids.shape == (u, min(kk + 1, g)) and v1.shape == (u, min(kk, g))
    theta = vals[:, kk] if vals.shape[1] > kk else torch.full((u,), float("-inf"))
    for c in range(u):
        col = gm[:, c]
        want = torch.sort(col, descending=True).values
        assert torch.equal(vals[c], want[: vals.shape[1]]) and torch.equal(v1[c], want[: v1.shape[1]])
        assert torch.equal(col[ids[c]], vals[c]) and torch.equal(col[i1[c]], v1[c])
        kept = set(ids[c, :kk].tolist())
        assert len(kept) == min(kk, g) and len(set(ids[c].tolist())) == ids.shape[1]
        left = torch.tensor([x for x in range(g) if x not in kept], dtype=torch.int64)
        largest_left = col[left].max() if len(left) else torch.tensor(float("-inf"))
        assert theta[c].view(torch.int32) == largest_left.view(torch.int32)
        if g <= kk:
            assert torch.isneginf(theta[c])
        elif name != "few_finite":
            assert want[kk - 1] > want[kk]  # a strict boundary: the set is unique
            assert kept == set(torch.argsort(col, descending=True)[:kk].tolist())
        else:
            assert set(range(5)) <= kept and torch.isneginf(theta[c])


BIG_N = 67_000  # 2,112 group maxima of 32 rows in the single pass: 16 whole super-groups and a tail of 64


def test_two_level_single_pass_equals_the_dense_reference(monkeypatch):
    """``recommend_batch`` on a catalog that takes the single pass with
    subgroups (groups of 32, subgroups of 8) and has more whole
    super-groups than kk, and a tail, so ``_submax_winners`` selects in two
    levels:
    every list equals the JAX package's dense one, and the FP32 bound
    certifies every user. The floor on the maxima a two-level selection
    takes is lifted for this small batch."""
    monkeypatch.setattr(base, "TWO_LEVEL_MIN_MAXIMA", 0)
    for name, value in {"_SERVE_ITEM_CHUNK": 2048, "_GROUP_TARGET": 32, "_SUBGROUP_TARGET": 8}.items():
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    monkeypatch.setattr(base.topk_streamed, "rechecked_users", 0)
    jm = jax_lstm.Hyperparameters(BIG_N, SEQ_LEN).embedding_dim(DIM).from_seed(51).build()
    tree = {
        "item_table": np.array(jm._params["item_table"]),
        "tower": {k: np.array(v) for k, v in jm._params["tower"].items()},
    }
    rng = np.random.default_rng(52)
    tree["item_table"][:, -1] = rng.normal(size=BIG_N) * 0.1
    tree["item_table"][65_600:66_100, -1] += 0.3  # in the tail's groups, so that some lists take items there
    jm._params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = lstm.Hyperparameters.from_dict(jm.hyper.to_dict()).build(torch.device("cpu"))
    pm.load_numpy_params(tree)
    hs = [rng.integers(0, BIG_N, rng.integers(1, 9)).tolist() for _ in range(40)]
    got = pm.recommend_batch(hs, k=K, return_scores=True)
    route, _ = base.topk_streamed.last_route
    kk = K + max(len(h) for h in hs)
    assert route.single_pass and (route.group, route.sub) == (32, 8)
    groups = tk.groupmax_rows(BIG_N, route.group)
    assert groups // base.SUPER_GROUP > kk and groups % base.SUPER_GROUP
    _assert_topk_equal(got, _reference(jm, hs))
    assert base.topk_streamed.rechecked_users == 0
