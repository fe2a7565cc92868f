"""The port's LSTM serving path against the JAX package's, on the CPU.

A JAX ``lstm`` model (embedding_dim 16, T = 8) gets random biases from
numpy; its parameters go to the port through ``params_from_numpy``. Both
then serve the same histories: user representations (atol 1e-5), ``predict``
and ``recommend_batch(k=6, return_scores=True)`` on each top-k route, with the
same budgets monkeypatched on both classes. Scores agree to 1e-5; ids agree
except where two candidates' scores tie within 1e-6.
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
from sbr_rs_tpu_torch.models import lstm
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
