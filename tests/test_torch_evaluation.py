"""The port's evaluation path against the JAX package's, on the CPU.

A JAX ``lstm`` model (embedding_dim 16, T = 8) gets random item and gate
biases from numpy; its parameters go to the port with
``load_numpy_params``. Both packages then rank the same held-out items:

* a single-chunk catalog, through the chunked counter on both sides;
* a multi-chunk catalog (``_ITEM_CHUNK`` = 2048 on both modules: three
  chunks, a clamped tail), where the port's fused counter (the plain
  version of the score + count kernel) is held against the JAX fused
  counter (its Pallas kernel in interpret mode), against both packages'
  chunked counters and against the per-user loop.

Ranks must be equal. That is a fair demand only without near-ties, so each
case first asserts that no other unseen item scores within 1e-6 of a
held-out item's score (f64 scores from the same parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbr_rs_tpu import data as jax_data
from sbr_rs_tpu import evaluation as jax_eval
from sbr_rs_tpu.errors import InvalidPredictionValue as JaxInvalidPrediction
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu_torch import data as torch_data
from sbr_rs_tpu_torch import evaluation
from sbr_rs_tpu_torch.errors import InvalidPredictionValue
from sbr_rs_tpu_torch.models import ImplicitUser, lstm
from sbr_rs_tpu_torch.ops import topk_kernels

SEQ_LEN = 8
DIM = 16
TIE = 1e-6  # no other unseen score this close to a target


def _models(num_items, seed=0):
    jm = (
        jax_lstm.Hyperparameters(num_items, SEQ_LEN)
        .embedding_dim(DIM)
        .lstm_variant(jax_lstm.LSTMVariant.NORMAL)
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
    return jm, pm, tree


def _histories(num_users, num_items, seed):
    """Histories of 1-11 items: every fifth user's held-out item is already
    in its prefix, every third repeats a seen item, every seventh has a
    single item (skipped by the protocol)."""
    rng = np.random.default_rng(seed)
    hs = []
    for u in range(num_users):
        h = rng.integers(0, num_items, int(rng.integers(3, 12))).tolist()
        if u % 5 == 0:
            h[-1] = h[0]
        if u % 3 == 0:
            h[1] = h[0]
        if u % 7 == 0:
            h = h[:1]
        hs.append(h)
    return hs


def _sets(hs, num_items):
    """The same interactions in both packages' compressed layout."""
    users = np.repeat(np.arange(len(hs)), [len(h) for h in hs])
    items = np.concatenate([np.asarray(h) for h in hs])
    ts = np.concatenate([np.arange(len(h)) for h in hs])
    return tuple(
        m.Interactions.from_arrays(users, items, ts, len(hs), num_items).to_compressed()
        for m in (jax_data, torch_data)
    )


def _assert_no_near_ties(jm, tree, hs):
    """No unseen item other than the held-out one scores within TIE of a
    held-out item's (unmasked) score, in f64."""
    qualifying = [h for h in hs if len(h) >= 2]
    reps = np.stack([u.user_embedding for u in jm.user_representations([h[:-1] for h in qualifying])])
    table = tree["item_table"].astype(np.float64)
    scores = reps.astype(np.float64) @ table[:, :-1].T + table[:, -1]
    for s, h in zip(scores, qualifying):
        if h[-1] in h[:-1]:
            continue  # target f32 min: no unseen score comes near it
        gap = np.abs(s - s[h[-1]])
        gap[h] = np.inf
        assert gap.min() > TIE


@pytest.fixture
def clear_jax_caches():
    jax_eval._make_catalog_counter.cache_clear()
    jax_eval._make_catalog_counter_pallas.cache_clear()
    yield
    jax_eval._make_catalog_counter.cache_clear()
    jax_eval._make_catalog_counter_pallas.cache_clear()


def test_single_chunk_ranks_match_jax(monkeypatch, clear_jax_caches):
    n = 300
    jm, pm, tree = _models(n, seed=1)
    hs = _histories(45, n, seed=2)
    _assert_no_near_ties(jm, tree, hs)
    jtest, ptest = _sets(hs, n)
    for module in (jax_eval, evaluation):
        monkeypatch.setattr(module, "_USER_BATCH", 16)  # two full batches and a partial one
    calls = []
    monkeypatch.setattr(evaluation, "score_count_ge", lambda *a: calls.append(a))
    want = jax_eval._ranks_batched(jm, jtest)
    got = evaluation._ranks_batched(pm, ptest)
    assert not calls  # a single chunk never takes the fused counter
    assert len(got) == sum(len(h) >= 2 for h in hs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(evaluation._ranks_generic(pm, ptest), want)
    # A held-out item already seen ranks last: the whole catalog.
    seen_again = [len(h) >= 2 and h[-1] in h[:-1] for h in hs]
    np.testing.assert_array_equal(got[[s for s, h in zip(seen_again, hs) if len(h) >= 2]], n)


@pytest.mark.parametrize("user_batch_fused", [16, 4096])
def test_multi_chunk_fused_ranks_match_jax(user_batch_fused, monkeypatch, clear_jax_caches):
    n = 5000
    jm, pm, tree = _models(n, seed=2)
    hs = _histories(40, n, seed=1)
    _assert_no_near_ties(jm, tree, hs)
    jtest, ptest = _sets(hs, n)
    for module in (jax_eval, evaluation):
        monkeypatch.setattr(module, "_ITEM_CHUNK", 2048)  # 3 chunks, clamped tail
        monkeypatch.setattr(module, "_USER_BATCH_FUSED", user_batch_fused)
        monkeypatch.setattr(module, "_USER_BATCH", 16)

    monkeypatch.setenv("SBR_PALLAS_EVAL", "1")
    with pltpu.force_tpu_interpret_mode():
        jax_fused = jax_eval._ranks_batched(jm, jtest)
    monkeypatch.setenv("SBR_PALLAS_EVAL", "0")
    jax_chunked = jax_eval._ranks_batched(jm, jtest)

    calls = []
    real = evaluation.score_count_ge

    def counting(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(evaluation, "score_count_ge", counting)
    fused = evaluation._ranks_batched(pm, ptest)
    assert calls == [16, 16, 2] if user_batch_fused == 16 else calls == [34]
    monkeypatch.setattr(evaluation, "count_supported", lambda *a: False)
    chunked = evaluation._ranks_batched(pm, ptest)

    np.testing.assert_array_equal(jax_fused, jax_chunked)
    for got in (fused, chunked, evaluation._ranks_generic(pm, ptest)):
        np.testing.assert_array_equal(got, jax_fused)


def test_counters_agree_on_one_batch():
    """The two counters called directly on the same batch: equal targets
    and ranks (``1 + counts - self_hits``), with and without a clamped last
    chunk. (Each judges the self-hit by its own score of the held-out item,
    so the two parts may split differently at the target.)"""
    n = 5000
    jm, pm, tree = _models(n, seed=2)
    hs = _histories(30, n, seed=1)
    _assert_no_near_ties(jm, tree, hs)
    _, ptest = _sets(hs, n)
    users = np.flatnonzero(np.diff(ptest.user_pointers) >= 2)
    inputs = evaluation._batch_inputs(pm, ptest, users, n)
    table = pm._params["item_table"]
    counts, self_hits, targets = evaluation._count_catalog_fused(table, *inputs, n)
    for chunk in (2048, 5000, 4999):
        c_counts, c_self_hits, c_targets = evaluation._count_catalog_chunked(table, *inputs, n, chunk)
        assert torch.equal(c_targets, targets)
        assert torch.equal(c_counts - c_self_hits, counts - self_hits)


@pytest.mark.parametrize("n,chunk", [(300, 65536), (5000, 2048)])
@pytest.mark.parametrize("metric", ["mrr", "hit_rate", "ndcg"])
def test_metrics_match_jax(metric, n, chunk, monkeypatch, clear_jax_caches):
    jm, pm, tree = _models(n, seed=2)
    hs = _histories(35, n, seed=1)
    _assert_no_near_ties(jm, tree, hs)
    jtest, ptest = _sets(hs, n)
    for module in (jax_eval, evaluation):
        monkeypatch.setattr(module, "_ITEM_CHUNK", chunk)
    name = f"{metric}_score"
    for k in ((None,) if metric == "mrr" else (1, 5, 10, n)):
        kw = {} if k is None else {"k": k}
        want = getattr(jax_eval, name)(jm, jtest, **kw)
        got = getattr(evaluation, name)(pm, ptest, **kw)
        assert np.isfinite(got) and abs(got - want) <= 1e-6
    if metric != "mrr":
        with pytest.raises(ValueError):
            getattr(evaluation, name)(pm, ptest, k=0)


class _StubModel:
    """score(item) = -item_id: item 0 always ranks first."""

    def user_representation(self, item_ids):
        return ImplicitUser(user_embedding=np.zeros(2, np.float32))

    def predict(self, user, item_ids):
        return -np.asarray(item_ids, dtype=np.float32)


STUB_CASES = {
    # name: (users, items, timestamps, num_items, metric, k, expected)
    "mrr": ([0, 0, 1, 1], [1, 0, 0, 2], [0, 1, 0, 1], 5, "mrr", None, (1.0 + 0.5) / 2),
    "seen_held_out": ([0, 0, 0], [1, 2, 1], [0, 1, 2], 4, "mrr", None, 0.25),
    "single_item_skipped": ([0, 1, 1, 1], [1, 0, 2, 3], [0, 0, 1, 2], 5, "mrr", None, 0.5),
    "hit_rate_1": ([0, 0, 1, 1], [1, 0, 0, 2], [0, 1, 0, 1], 5, "hit_rate", 1, 0.5),
    "hit_rate_2": ([0, 0, 1, 1], [1, 0, 0, 2], [0, 1, 0, 1], 5, "hit_rate", 2, 1.0),
    "ndcg_1": ([0, 0, 1, 1], [1, 0, 0, 2], [0, 1, 0, 1], 5, "ndcg", 1, 0.5),
    "ndcg_2": ([0, 0, 1, 1], [1, 0, 0, 2], [0, 1, 0, 1], 5, "ndcg", 2, (1.0 + 1.0 / np.log2(3.0)) / 2),
}


@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_generic_semantics(case):
    """The reference protocol on a stub model, as the JAX package's tests
    pin it, through the port's per-user loop."""
    users, items, ts, n, metric, k, want = STUB_CASES[case]
    test = torch_data.Interactions.from_arrays(
        np.array(users), np.array(items), np.array(ts), num_users=max(users) + 1, num_items=n
    ).to_compressed()
    kw = {} if k is None else {"k": k}
    assert abs(getattr(evaluation, f"{metric}_score")(_StubModel(), test, **kw) - want) < 1e-9


def test_generic_ranks_match_jax():
    n = 300
    jm, pm, tree = _models(n, seed=1)
    hs = _histories(20, n, seed=3)
    _assert_no_near_ties(jm, tree, hs)
    jtest, ptest = _sets(hs, n)
    np.testing.assert_array_equal(
        evaluation._ranks_generic(pm, ptest), jax_eval._ranks_generic(jm, jtest)
    )


def test_empty_test_set_gives_nan():
    _, pm, _ = _models(300)
    _, ptest = _sets([[1], [2]], 300)
    assert np.isnan(evaluation.mrr_score(pm, ptest))
    assert np.isnan(evaluation.hit_rate_score(pm, ptest, k=3))
    assert evaluation._ranks_batched(pm, ptest).shape == (0,)


@pytest.mark.parametrize("bad", ["held_out", "prefix"])
def test_out_of_range_items_raise(bad):
    n = 300
    jm, pm, _ = _models(n)
    ids = [[3, 4, 5], [6, 7, n]] if bad == "held_out" else [[3, 4, 5], [6, n + 2, 8]]
    lens = [len(h) for h in ids]
    flat = np.concatenate(ids)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    for data_mod, model, error in ((jax_data, jm, JaxInvalidPrediction), (torch_data, pm, InvalidPredictionValue)):
        test = data_mod.CompressedInteractions(2, n, ptr, flat, np.zeros_like(flat))
        with pytest.raises(error):
            (jax_eval if data_mod is jax_data else evaluation).mrr_score(model, test)


def test_evaluation_launches_no_kernel_on_the_cpu(monkeypatch):
    monkeypatch.setattr(topk_kernels.score_count_ge, "launches", 0)
    monkeypatch.setattr(evaluation, "_ITEM_CHUNK", 2048)
    _, pm, _ = _models(5000)
    _, ptest = _sets(_histories(10, 5000, seed=11), 5000)
    assert np.isfinite(evaluation.mrr_score(pm, ptest))
    assert topk_kernels.score_count_ge.launches == 0
