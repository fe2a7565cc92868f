"""The port's LSTM serving path against the JAX package's, on the CPU.

A JAX ``lstm`` model (embedding_dim 16, T = 8) gets random biases from
numpy; its parameters go to the port through ``params_from_numpy``. Both
then serve the same histories: user representations (atol 1e-5), ``predict``
and ``recommend_batch(k=6, return_scores=True)`` on each top-k route, with the
same budgets monkeypatched on both classes. Scores agree to 1e-5; ids agree
except where two candidates' scores tie within 1e-6. The port's
``approximate=True`` serves the JAX package's exact list. The budgets a card
derives from its free memory (monkeypatched in: a CPU model reads it as a
card would) flip the route at the derived thresholds, and the lists stay the
JAX package's exact list on every side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbr_rs_tpu.errors import InvalidPredictionValue as JaxInvalidPrediction
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu.models.base import ImplicitSequenceModel as JaxModel
from sbr_rs_tpu_torch.errors import InvalidPredictionValue
from sbr_rs_tpu_torch.models import base, lstm
from sbr_rs_tpu_torch.models.base import ImplicitSequenceModel

ATOL = 1e-5
SEQ_LEN = 8
DIM = 16
VARIANTS = ["NORMAL", "COUPLED"]


def _models(num_items, variant, seed=0):
    jm = (
        jax_lstm.Hyperparameters(num_items, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(getattr(jax_lstm.LSTMVariant, variant))
        .from_seed(seed)
        .build()
    )
    tree = {
        "item_table": np.array(jm._params["item_table"]),
        "tower": {k: np.array(v) for k, v in jm._params["tower"].items()},
    }
    rng = np.random.default_rng(seed)
    tree["item_table"][:, -1] = rng.normal(size=num_items) * 0.1
    tree["tower"]["b"] = (rng.normal(size=tree["tower"]["b"].shape) * 0.1).astype(np.float32)
    jm._params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = lstm.Hyperparameters.from_dict(jm.hyper.to_dict()).build(torch.device("cpu"))
    pm.load_numpy_params(tree)
    return jm, pm


def _histories(num_items, rng, wide=False):
    hs = [[], [1, 2, 3], list(range(20)), [num_items - 1]]
    hs += [rng.integers(0, num_items, rng.integers(2, 12)).tolist() for _ in range(4)]
    if wide:  # seen lists past the post-filter limit of 128
        hs += [rng.integers(0, num_items, 150).tolist(), list(range(0, num_items, 37))]
    return hs


def _assert_topk_equal(got, want):
    (gi, gv), (wi, wv) = got, want
    gi, wi = np.asarray(gi), np.asarray(wi)
    assert gi.shape == wi.shape and gv.shape == wv.shape
    np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=0)
    gaps = np.abs(np.diff(wv, axis=1)) <= 1e-6
    tied = np.zeros(wv.shape, bool)
    tied[:, :-1] |= gaps
    tied[:, 1:] |= gaps
    np.testing.assert_array_equal(gi[~tied], wi[~tied])
    for row in gi:
        assert len(set(row.tolist())) == len(row)


@pytest.fixture
def clear_jax_topk_cache():
    JaxModel._TOPK_FN_CACHE.clear()
    yield
    JaxModel._TOPK_FN_CACHE.clear()


@pytest.mark.parametrize("variant", VARIANTS)
def test_representations_and_predict_match_jax(variant):
    n = 300
    jm, pm = _models(n, variant, seed=1)
    hs = _histories(n, np.random.default_rng(0))
    want = np.stack([u.user_embedding for u in jm.user_representations(hs)])
    got = np.stack([u.user_embedding for u in pm.user_representations(hs)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        pm.user_representation(hs[2]).user_embedding, want[2], atol=ATOL, rtol=0
    )
    user = pm.user_representation([4, 5, 6])
    for ids in ([0, 7, n - 1], None):
        np.testing.assert_allclose(pm.predict(user, ids), jm.predict(user, ids), atol=ATOL, rtol=0)


ROUTES = {
    # name: (num_items, constants patched on both classes, wide seen lists)
    "dense_small": (300, {}, False),
    "streamed_single_pass": (5000, {"_SERVE_ITEM_CHUNK": 2048}, False),
    "running_merge": (5000, {"_SERVE_ITEM_CHUNK": 2048, "_MERGE_BUFFER_BYTES": 0}, False),
    "wide_seen": (5000, {"_SERVE_ITEM_CHUNK": 2048}, True),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_recommend_batch_matches_jax(route, variant, monkeypatch, clear_jax_topk_cache):
    n, patch, wide = ROUTES[route]
    for name, value in patch.items():
        monkeypatch.setattr(JaxModel, name, value)
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    jm, pm = _models(n, variant, seed=2)
    hs = _histories(n, np.random.default_rng(3), wide=wide)
    # A history holding its own best items: the last SEQ_LEN ids fix the
    # representation, the items before them are its top 6, which must go.
    tail = list(range(100, 100 + SEQ_LEN))
    hs.append(jm.recommend(tail, k=6, exclude_seen=False) + tail)
    _assert_topk_equal(
        pm.recommend_batch(hs, k=6, return_scores=True),
        jm.recommend_batch(hs, k=6, return_scores=True),
    )
    for h, row in zip(hs, pm.recommend_batch(hs, k=6)):
        assert not set(row) & set(h)
    _assert_topk_equal(
        pm.recommend_batch(hs, k=6, exclude_seen=False, return_scores=True),
        jm.recommend_batch(hs, k=6, exclude_seen=False, return_scores=True),
    )


def test_recommend_batch_matches_jax_pallas_kernel(monkeypatch, clear_jax_topk_cache):
    """The JAX side on its fused Pallas kernel (interpret mode): the
    whole-catalog score + submax + groupmax call the port's kernel replaces."""
    n = 5000
    monkeypatch.setattr(JaxModel, "_SERVE_ITEM_CHUNK", 2048)
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 2048)
    monkeypatch.setenv("SBR_PALLAS_TOPK", "1")
    jm, pm = _models(n, "NORMAL", seed=4)
    hs = _histories(n, np.random.default_rng(5))
    with pltpu.force_tpu_interpret_mode():
        want = jm.recommend_batch(hs, k=6, return_scores=True)
    _assert_topk_equal(pm.recommend_batch(hs, k=6, return_scores=True), want)


def test_out_of_range_ids_raise_like_jax():
    n = 300
    jm, pm = _models(n, "NORMAL")
    user = pm.user_representation([1])
    for model, error in ((jm, JaxInvalidPrediction), (pm, InvalidPredictionValue)):
        with pytest.raises(error):
            model.predict(user, [0, n])
        with pytest.raises(error):
            model.predict(user, [-1])
        with pytest.raises(error):
            model.user_representation([1, n])
        with pytest.raises(error):
            model.recommend_batch([[2], [n + 5]], k=3)


@pytest.mark.parametrize("route", ["streamed_single_pass", "running_merge"])
def test_approximate_serves_the_exact_list(route, monkeypatch, clear_jax_topk_cache):
    """``approximate=True`` at any recall target in (0, 1] gives the JAX
    package's exact list; a target outside it raises in both packages (in
    the JAX package where its approximate mode runs: a streamed catalog)."""
    n, patch, _ = ROUTES[route]
    for name, value in patch.items():
        monkeypatch.setattr(JaxModel, name, value)
        monkeypatch.setattr(ImplicitSequenceModel, name, value)
    jm, pm = _models(n, "NORMAL", seed=6)
    hs = _histories(n, np.random.default_rng(7))
    want = jm.recommend_batch(hs, k=6, return_scores=True)
    for target in (0.5, 0.95, 1.0):
        got = pm.recommend_batch(hs, k=6, approximate=True, recall_target=target, return_scores=True)
        _assert_topk_equal(got, want)
    for target in (0.0, 1.5):
        with pytest.raises(ValueError):
            pm.recommend_batch(hs, k=6, approximate=True, recall_target=target)
        with pytest.raises((ValueError, jax.errors.JaxRuntimeError)):
            jm.recommend_batch(hs, k=6, approximate=True, recall_target=target)


GiB = 1 << 30


def test_budget_share_splits_each_card_and_takes_the_least():
    """A card's free bytes less the margin, split among the ranks on it,
    plus each rank's own cache; the least over the ranks."""
    margin = int(base.BUDGET_MARGIN * 80 * GiB)
    assert base.budget_share([(7, 60 * GiB, 2 * GiB, 80 * GiB)]) == 60 * GiB - margin + 2 * GiB
    four = [(7, 40 * GiB, c * GiB, 80 * GiB) for c in (3, 1, 2, 4)]
    assert base.budget_share(four) == (40 * GiB - margin) // 4 + 1 * GiB
    two_cards = [(7, 50 * GiB, 0, 80 * GiB), (9, 30 * GiB, 0, 80 * GiB)]
    assert base.budget_share(two_cards) == 30 * GiB - margin
    assert base.budget_share([(7, 1 * GiB, 0, 80 * GiB)]) == 0


def test_derived_budgets_keep_the_floors():
    big = base.derive_budgets(50 * GiB, 10_000_000, 4096, serve_chunk=131072, group_target=128)
    group_stack = 77 * 1024 * 4096 * 4
    assert big == (50 * GiB, 50 * GiB - group_stack, 25 * GiB)
    small = base.derive_budgets(GiB, 10_000_000, 4096, serve_chunk=131072, group_target=128)
    assert small == (base.MERGE_BUFFER_FLOOR, base.SUBMAX_BUFFER_FLOOR, base.PHASE2_BUFFER_FLOOR)


def test_the_cpu_keeps_the_constants_and_a_set_budget_is_fixed(monkeypatch):
    _, pm = _models(300, "NORMAL")
    floors = (6 << 30, 6 << 30, 1_200_000_000)
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 128)
    assert pm._serving_budgets(4096, 8) == floors
    monkeypatch.setattr(base, "card_reading", lambda device: (1, 100 * GiB, 0, 0))
    assert pm._serving_budgets(4096, 8)[0] == 100 * GiB
    pm._MERGE_BUFFER_BYTES, pm._PHASE2_BUFFER_BYTES = 0, 5
    assert pm._serving_budgets(4096, 8) == (0, 100 * GiB - 3 * 4096 * 4, 5)  # 3 chunks of one group
    assert pm._serving_budgets(4096, 200) == (0, floors[1], 5)  # wide seen lists: no reading


def test_ranks_of_a_mesh_take_the_same_budgets(monkeypatch):
    """Under a mesh each rank's reading travels in the all-gather, and every
    rank derives its budgets from the least share, for the largest slab."""
    _, pm = _models(5000, "NORMAL")
    monkeypatch.setattr(ImplicitSequenceModel, "_SERVE_ITEM_CHUNK", 1024)
    mine, other = (1, 20 * GiB, 0, 0), (2, 12 * GiB, GiB, 0)

    class TwoSlabs:
        model = 2
        backend = "gloo"

        def all_gather(self, t, axis):
            assert axis is None and tuple(t.tolist()) == mine
            return [t, torch.tensor(other)]

    monkeypatch.setattr(base, "card_reading", lambda device: mine)
    pm.hyper._mesh = TwoSlabs()
    want = base.derive_budgets(13 * GiB, 2500, 64, serve_chunk=1024, group_target=128)
    assert pm._serving_budgets(64, 8) == want


def test_the_route_follows_the_free_memory(monkeypatch, clear_jax_topk_cache):
    """Floors at 0 and the free memory ``avail`` monkeypatched: the running
    merge below twice the group stack G, the group-only single pass from 2G,
    subgroups of 64 from 3G (their stack, 2G, beside G) and of 32 from 5G;
    the list is the JAX package's exact list on each side of each
    threshold."""
    n = 5000
    for cls in (JaxModel, ImplicitSequenceModel):
        monkeypatch.setattr(cls, "_SERVE_ITEM_CHUNK", 2048)
    for name in ("MERGE_BUFFER_FLOOR", "SUBMAX_BUFFER_FLOOR", "PHASE2_BUFFER_FLOOR"):
        monkeypatch.setattr(base, name, 0)
    jm, pm = _models(n, "NORMAL", seed=8)
    hs = _histories(n, np.random.default_rng(9))
    want = jm.recommend_batch(hs, k=6, return_scores=True)
    u = len(hs)
    g = 3 * 16 * u * 4  # the group-maxima stack: 3 chunks of 16 groups
    sides = [(2 * g - 1, False, 128), (2 * g, True, 128), (3 * g - 1, True, 128), (3 * g, True, 64),
             (5 * g - 1, True, 64), (5 * g, True, 32)]
    for avail, single_pass, sub in sides:
        monkeypatch.setattr(base, "card_reading", lambda device, avail=avail: (1, avail, 0, 0))
        base.topk_streamed.last_route = None
        _assert_topk_equal(pm.recommend_batch(hs, k=6, return_scores=True), want)
        route, budgets = base.topk_streamed.last_route
        assert (route.single_pass, route.sub) == (single_pass, sub), (avail, route)
        assert budgets == (avail, avail - g, avail // 2)


def test_the_margin_moves_the_threshold(monkeypatch, clear_jax_topk_cache):
    """On a card of ``total`` bytes the single pass needs BUDGET_MARGIN of
    the total free beyond twice the group stack G, to the byte: one byte
    less serves the running merge. Four ranks on the card split what is
    left. The JAX package's exact list on each side."""
    n = 5000
    for cls in (JaxModel, ImplicitSequenceModel):
        monkeypatch.setattr(cls, "_SERVE_ITEM_CHUNK", 2048)
    for name in ("MERGE_BUFFER_FLOOR", "SUBMAX_BUFFER_FLOOR", "PHASE2_BUFFER_FLOOR"):
        monkeypatch.setattr(base, name, 0)
    jm, pm = _models(n, "NORMAL", seed=8)
    hs = _histories(n, np.random.default_rng(9))
    want = jm.recommend_batch(hs, k=6, return_scores=True)
    g = 3 * 16 * len(hs) * 4
    total = 16 * GiB
    margin = int(base.BUDGET_MARGIN * total)
    assert margin == GiB
    for free, single_pass in ((margin + 2 * g - 1, False), (margin + 2 * g, True)):
        monkeypatch.setattr(base, "card_reading", lambda device, free=free: (1, free, 0, total))
        _assert_topk_equal(pm.recommend_batch(hs, k=6, return_scores=True), want)
        assert base.topk_streamed.last_route[0].single_pass == single_pass, free
    assert base.budget_share([(1, margin + 8 * g, 0, total)] * 4) == 2 * g
