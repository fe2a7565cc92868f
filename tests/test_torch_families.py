"""The port's EWMA, GRU and attention families against the JAX package's, on
the CPU: hyperparameter dicts, parameters, serving and evaluation.

Each JAX model (N = 60 items, D = 8, T = 8; attention with 2 heads and 2
layers) gets random numpy parameters in every leaf, with item biases of
spread 1 so that no two scores come near a tie; the port model is built from
the JAX model's ``to_dict`` and takes the same parameters by
``load_numpy_params``. User representations agree within rtol 1e-5 / atol
1e-6, ``recommend_batch`` returns the same ids with scores within 1e-5, and
MRR, hit rate@5 and NDCG@5 agree within 1e-6 relative. ``random(seed)``
makes the JAX package's numpy draws, field by field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu import evaluation as jax_eval
from sbr_rs_tpu.models import attention as jax_attention
from sbr_rs_tpu.models import ewma as jax_ewma
from sbr_rs_tpu.models import gru as jax_gru
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu_torch import datasets, evaluation
from sbr_rs_tpu_torch.models import OnlineRankingModel, attention, base, ewma, gru, lstm
from sbr_rs_tpu_torch.utils.tree import flatten

NUM_ITEMS, DIM, SEQ_LEN = 60, 8, 8
FAMILIES = {"ewma": (jax_ewma, ewma), "gru": (jax_gru, gru), "attention": (jax_attention, attention)}


def _jax_hyper(name, seed=3):
    jax_mod, _ = FAMILIES[name]
    hp = jax_mod.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM).from_seed(seed)
    if name == "attention":
        hp = hp.num_layers(2).num_heads(2)
    if name == "ewma":
        hp = hp.alpha_init(1.5)
    return hp


def _models(name, seed=3):
    """A JAX model with random numpy parameters and the port's copy of it."""
    jm = _jax_hyper(name, seed).build()
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jm._params)
    tree = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype), tree)
    tree["item_table"][:, -1] = rng.normal(size=NUM_ITEMS)
    jm._params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = FAMILIES[name][1].Hyperparameters.from_dict(jm.hyper.to_dict()).build("cpu")
    pm.load_numpy_params(tree)
    return jm, pm


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_hyperparameters_round_trip_with_jax(name):
    jax_mod, mod = FAMILIES[name]
    jhp = (_jax_hyper(name).table_dtype("bfloat16").lr_schedule("cosine").packed(True)
           .sparse_updates(True).embedding_dim(16))
    if name == "attention":
        jhp = jhp.dropout(0.3)
    jd = jhp.to_dict()
    assert jd["model_type"] == name
    hp = mod.Hyperparameters.from_dict(jd)
    assert hp.to_dict() == jd
    assert jax_mod.Hyperparameters.from_dict(hp.to_dict()).to_dict() == jd


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_builds_on_the_card_by_default_and_never_falls_back(name, monkeypatch):
    import torch

    hp = FAMILIES[name][1].Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(DIM)
    assert hp.build("cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        hp.build()
    with pytest.raises(RuntimeError):
        hp.build(torch.device("cuda"))


def test_attention_hyperparameters_validate():
    hp = attention.Hyperparameters(NUM_ITEMS, SEQ_LEN).embedding_dim(10).num_heads(3)
    with pytest.raises(ValueError):
        hp.build("cpu")
    for bad in (lambda h: h.dropout(1.0), lambda h: h.num_layers(0), lambda h: h.num_heads(0)):
        with pytest.raises(ValueError):
            bad(attention.Hyperparameters(NUM_ITEMS, SEQ_LEN))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_load_numpy_params_keeps_the_tree(name):
    jm, pm = _models(name)
    want = jax.tree_util.tree_leaves(jm._params["tower"])
    got = flatten(pm._params["tower"])
    assert len(got) == len(want)
    for (path, v), w in zip(got, want):
        np.testing.assert_array_equal(v.numpy(), np.asarray(w), err_msg=path)
    tree = jax.tree_util.tree_map(np.asarray, jm._params)
    if name == "attention":
        parent, key = tree["tower"]["layers"][1], "b_f1"
    else:
        parent, key = tree["tower"], sorted(tree["tower"])[0]
    parent[key] = parent[key][:-1]  # one leaf's shape no longer matches
    with pytest.raises(ValueError):
        pm.load_numpy_params(tree)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_serving_and_evaluation_match_jax(name):
    jm, pm = _models(name)
    assert isinstance(pm, OnlineRankingModel)
    rng = np.random.default_rng(5)
    hs = [rng.integers(0, NUM_ITEMS, rng.integers(1, 14)).tolist() for _ in range(24)]  # some past T
    reps_p = np.stack([u.user_embedding for u in pm.user_representations(hs)])
    reps_j = np.stack([np.asarray(u.user_embedding) for u in jm.user_representations(hs)])
    np.testing.assert_allclose(reps_p, reps_j, rtol=1e-5, atol=1e-6)
    ids_p, s_p = pm.recommend_batch(hs, k=5, return_scores=True)
    ids_j, s_j = jm.recommend_batch(hs, k=5, return_scores=True)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-5, atol=1e-5)
    assert np.asarray(ids_p).tolist() == np.asarray(ids_j).tolist()
    np.testing.assert_allclose(pm.predict(pm.user_representation(hs[0]), [3, 7, 11]),
                               np.asarray(jm.predict(jm.user_representation(hs[0]), [3, 7, 11])),
                               rtol=1e-5, atol=1e-5)

    test_p = datasets.synthetic_interactions(30, NUM_ITEMS, 9, rng=2).to_compressed()
    test_j = jax_datasets.synthetic_interactions(30, NUM_ITEMS, 9, rng=2).to_compressed()
    for port_fn, jax_fn, kw in (
        (evaluation.mrr_score, jax_eval.mrr_score, {}),
        (evaluation.hit_rate_score, jax_eval.hit_rate_score, {"k": 5}),
        (evaluation.ndcg_score, jax_eval.ndcg_score, {"k": 5}),
    ):
        got, want = port_fn(pm, test_p, **kw), float(jax_fn(jm, test_j, **kw))
        assert 0 < want <= 1
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=port_fn.__name__)


FAMILY_RANDOM = [
    ("lstm", jax_lstm, lstm), ("ewma", jax_ewma, ewma), ("gru", jax_gru, gru),
    ("attention", jax_attention, attention),
]


@pytest.mark.parametrize("seed", [0, 11, 2024, 7, 99])
@pytest.mark.parametrize("name, jax_mod, mod", FAMILY_RANDOM)
def test_random_makes_the_jax_draws(name, jax_mod, mod, seed, monkeypatch):
    """Over as many devices on both sides (the port's one CPU device against
    JAX told it has one; eight against JAX's eight virtual CPU devices of
    ``tests/conftest.py``), every field agrees, ``num_threads`` included."""
    with monkeypatch.context() as m:
        m.setattr(jax, "device_count", lambda: 1)
        want_one = jax_mod.Hyperparameters.random(1234, seed).to_dict()
    got_one = mod.Hyperparameters.random(1234, seed).to_dict()
    assert got_one["num_threads"] == 1 and got_one["model_type"] == name
    assert got_one == want_one
    want_eight = jax_mod.Hyperparameters.random(1234, np.random.default_rng(seed)).to_dict()
    monkeypatch.setattr(base, "device_count", lambda: jax.device_count())
    assert mod.Hyperparameters.random(1234, np.random.default_rng(seed)).to_dict() == want_eight


def test_random_models_build_and_fit():
    data = datasets.synthetic_interactions(30, 40, 10, rng=0).to_compressed()
    for seed, (_, _, mod) in enumerate(FAMILY_RANDOM):
        hp = mod.Hyperparameters.random(40, seed).num_epochs(1).embedding_dim(8)
        hp._max_sequence_length = 8
        assert np.isfinite(hp.build("cpu").fit(data))
