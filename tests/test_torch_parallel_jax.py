"""The port's sharded fit against the JAX package's, on the CPU.

The JAX model trains on a ``make_mesh(data, model)`` mesh over four of the
8 virtual CPU devices of ``tests/conftest.py``; the port trains the same
configuration in four gloo processes on the same mesh shape
(``scripts/torch_multiprocess_fit.py``, which imports no jax), from the JAX
model's initial parameters and with the JAX fit's own permutations and
candidates (drawn as ``tests/test_torch_fit.py`` draws them). After two
epochs the epoch losses agree within rtol 1e-4, the gathered parameters
within rtol 2e-4 / atol 1e-3, and the MRR as ``tests/test_sharding.py``
holds the JAX sharded model to the unsharded one (rtol 1e-3, attention
1e-2). The cases cover the LSTM, EWMA, GRU and attention, WARP, Hinge and
BPR (with Adam, as ``tests/test_torch_family_fit.py`` pairs them), Adagrad
and Adam, the row-sharded sparse step (``model = 2``) and a data-only dense
step.

Serving on the row-sharded table: the trained JAX LSTM serves
``SERVE_HISTORIES`` on its ``(2, 2)`` mesh through its ``shard_map``
composition of the Pallas kernel (interpret mode, catalog chunks of 8, as
``tests/test_sharding.py`` runs it), and four port ranks serve them from
the same weights (each slab's top-k, then the cross-shard merge): the
lists are equal and the scores agree to 1e-5.

Checkpoints across world sizes: the 4-rank port saves (rank 0 writes, the
slabs streamed to it); the JAX package and the port at world size 1 load it
with the gathered table bit for bit; 2 ranks load it and save again to the
same bytes; and 4 ranks load a JAX checkpoint bit for bit. Each group of
ranks is killed and failed after 120 s.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu import evaluation as jax_evaluation
from sbr_rs_tpu.models import Loss as JLoss
from sbr_rs_tpu.models import Optimizer as JOptimizer
from sbr_rs_tpu.models import attention as jax_attention
from sbr_rs_tpu.models import ewma as jax_ewma
from sbr_rs_tpu.models import gru as jax_gru
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu.models.base import ImplicitSequenceModel as JaxModel
from sbr_rs_tpu.parallel import make_mesh as jax_make_mesh
from sbr_rs_tpu.utils import checkpoint as jax_checkpoint
from sbr_rs_tpu_torch import datasets
from sbr_rs_tpu_torch.models import Loss, Optimizer, attention, ewma, gru, lstm
from sbr_rs_tpu_torch.utils import checkpoint
from sbr_rs_tpu_torch.utils.tree import flatten

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts.torch_multiprocess_fit import SERVE_HISTORIES, launch  # noqa: E402

RTOL, ATOL = 2e-4, 1e-3
NUM_ITEMS = 64
DATA = [40, NUM_ITEMS, 15, 0]
GROUP_TIMEOUT_S = 120
FAMILIES = {"lstm": (jax_lstm, lstm), "ewma": (jax_ewma, ewma), "gru": (jax_gru, gru),
            "attention": (jax_attention, attention)}

# (name, family, loss, optimizer, packed, sparse, mesh)
CASES = [
    ("lstm-coupled-warp-adagrad", "lstm", Loss.WARP, Optimizer.ADAGRAD, True, True, (2, 2)),
    ("ewma-hinge-adam", "ewma", Loss.HINGE, Optimizer.ADAM, False, True, (2, 2)),
    ("lstm-hinge-adagrad-dense-d4", "lstm", Loss.HINGE, Optimizer.ADAGRAD, True, False, (4, 1)),
    ("gru-bpr-adam", "gru", Loss.BPR, Optimizer.ADAM, False, True, (2, 2)),
    ("attention-warp-adam", "attention", Loss.WARP, Optimizer.ADAM, True, True, (2, 2)),
]
SAVED = CASES[0][0]  # the case whose trained model the 4 ranks save, and serve
SERVE_K, SERVE_CHUNK = 5, 8


def _jax_hyper(family, loss, kind, packed, sparse, mesh=None):
    hp = (
        FAMILIES[family][0].Hyperparameters(NUM_ITEMS, 8)
        .embedding_dim(8)
        .learning_rate(0.05)
        .l2_penalty(1e-3)
        .loss(JLoss(loss.value))
        .optimizer(JOptimizer(kind.value))
        .num_epochs(2)
        .batch_size(16)
        .packed(packed)
        .sparse_updates(sparse)
        .from_seed(3)
    )
    if family == "attention":
        hp = hp.num_layers(1).num_heads(2)
    if family == "lstm" and loss == Loss.WARP:
        hp = hp.lstm_variant(jax_lstm.LSTMVariant.COUPLED)
    if mesh is not None:
        hp = hp.mesh(jax_make_mesh(data=mesh[0], model=mesh[1], devices=jax.devices()[: mesh[0] * mesh[1]]))
    return hp


def _numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_draws(jm, port_hyper, data_size):
    """The JAX fit's permutations ``[epochs, n]`` and candidates ``[steps,
    B, T, K]`` from the model's key (``tests/test_torch_fit.py``)."""
    _, key_fit = jax.random.split(jm._key)
    key_steps, key_perm = jax.random.split(key_fit)
    n = port_hyper.build("cpu")._windows(datasets.synthetic_interactions(*data_size[:3], rng=data_size[3])
                                         .to_compressed())[3]
    hp = jm.hyper
    batch = min(hp._batch_size, n)
    data_axis = hp._mesh.shape["data"]
    batch = -(-batch // data_axis) * data_axis
    steps = hp._num_epochs * -(-n // batch)
    k = 5 if hp._loss == JLoss.WARP else 1
    perm = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key_perm, e), n))
                     for e in range(hp._num_epochs)])
    cand = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key_steps, s),
                                                   (batch, hp._max_sequence_length, k), 0, NUM_ITEMS,
                                                   dtype=jnp.int32)) for s in range(steps)])
    return perm.astype(np.int64), cand.astype(np.int64)


def _jax_sharded_serving(jm):
    """``recommend_batch`` of a JAX model on its ``(2, 2)`` mesh through
    the ``shard_map`` composition of the Pallas kernel, in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "_SERVE_ITEM_CHUNK", SERVE_CHUNK)
        mp.setenv("SBR_PALLAS_TOPK", "1")
        mp.setenv("SBR_PALLAS_INTERPRET", "1")
        JaxModel._TOPK_FN_CACHE.clear()
        try:
            ids, vals = jm.recommend_batch(SERVE_HISTORIES, k=SERVE_K, return_scores=True)
        finally:
            JaxModel._TOPK_FN_CACHE.clear()
    return np.asarray(ids), np.asarray(vals)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX fits, then one group of 4 port ranks over every case (and a
    JAX checkpoint to load), then 2 ranks loading the 4 ranks' checkpoint."""
    tmp = tmp_path_factory.mktemp("parallel_jax")
    jmat = jax_datasets.synthetic_interactions(*DATA[:3], rng=DATA[3]).to_compressed()
    inputs, cases, want = {}, [], {}
    for name, family, loss, kind, packed, sparse, mesh in CASES:
        jm = _jax_hyper(family, loss, kind, packed, sparse, mesh).build()
        port_hyper = FAMILIES[family][1].Hyperparameters.from_dict(jm.hyper.to_dict())
        for path, v in flatten(_numpy(jm._params)):
            inputs[f"{name}.init.{path}"] = v
        inputs[f"{name}.perm"], inputs[f"{name}.cand"] = _jax_draws(jm, port_hyper, DATA)
        jm.fit(jmat)
        if name == SAVED:
            want["serve"] = _jax_sharded_serving(jm)
            for path, v in flatten(_numpy(jm._params)):
                inputs[f"serve.init.{path}"] = v
            cases.append({"name": "serve", "family": family, "hyper": port_hyper.to_dict(), "mesh": list(mesh),
                          "init": True, "recommend": {"k": SERVE_K,
                                                      "routes": {"chunk": {"_SERVE_ITEM_CHUNK": SERVE_CHUNK}}}})
        want[name] = {
            "epoch_losses": np.asarray(jm.history.epoch_losses),
            "params": _numpy(jm._params),
            "mrr": jax_evaluation.mrr_score(jm, jmat),
        }
        case = {"name": name, "family": family, "hyper": port_hyper.to_dict(), "mesh": list(mesh),
                "data": DATA, "init": True, "draws": True, "fit": True, "eval": True, "gather": True}
        if name == SAVED:
            case["save"] = str(tmp / "ws4")
        cases.append(case)
    jax_model = _jax_hyper("gru", Loss.HINGE, Optimizer.ADAGRAD, False, True).build()
    jax_model.save(str(tmp / "jax"))
    want["jax-checkpoint"] = {"params": _numpy(jax_model._params)}
    cases.append({"name": "jax-checkpoint", "load": str(tmp / "jax"), "mesh": [2, 2], "gather": True})
    np.savez(tmp / "inputs.npz", **inputs)
    spec = {"backend": "gloo", "device": "cpu", "timeout_s": 60, "inputs": str(tmp / "inputs.npz"),
            "out": str(tmp / "out4.npz"), "cases": cases}
    got4 = launch(4, spec, str(tmp / "spec4.json"), GROUP_TIMEOUT_S)
    spec2 = {"backend": "gloo", "device": "cpu", "timeout_s": 60, "inputs": None, "out": str(tmp / "out2.npz"),
             "cases": [{"name": "ws2", "load": str(tmp / "ws4"), "mesh": [1, 2], "gather": True,
                        "save": str(tmp / "ws2")}]}
    got2 = launch(2, spec2, str(tmp / "spec2.json"), GROUP_TIMEOUT_S)
    return {"want": want, "got4": got4, "got2": got2, "tmp": tmp}


def _assert_params(arrays, prefix, params, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(arrays[f"{prefix}.item_table"], params["item_table"], rtol=rtol, atol=atol)
    for path, v in flatten(params["tower"]):
        np.testing.assert_allclose(arrays[f"{prefix}.tower.{path}"], v, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_fit_matches_jax(runs, case):
    name, family = case[0], case[1]
    got = runs["got4"]["cases"][name]
    arrays = runs["got4"]["arrays"]
    want = runs["want"][name]
    assert got["mesh"] == list(case[6])
    assert got["replicas_equal"]
    np.testing.assert_allclose(arrays[f"{name}.epoch_losses"], want["epoch_losses"], rtol=1e-4)
    _assert_params(arrays, f"{name}.params", want["params"])
    np.testing.assert_allclose(got["mrr"], want["mrr"], rtol=1e-2 if family == "attention" else 1e-3)


def test_sharded_checkpoint_loads_in_jax_and_at_world_size_one(runs):
    arrays = runs["got4"]["arrays"]
    path = str(runs["tmp"] / "ws4")
    jax_params = _numpy(jax_checkpoint.load_model(path)._params)
    port = checkpoint.load_model(path, "cpu")
    for params in (jax_params, {"item_table": port._params["item_table"].numpy(),
                                "tower": {k: v.numpy() for k, v in port._params["tower"].items()}}):
        _assert_params(arrays, f"{SAVED}.params", params, rtol=0, atol=0)


def test_sharded_checkpoint_loads_at_world_size_two(runs):
    got2 = runs["got2"]
    _assert_params(got2["arrays"], "ws2.params", {
        "item_table": runs["got4"]["arrays"][f"{SAVED}.params.item_table"],
        "tower": {path[len(f"{SAVED}.params.tower."):]: v for path, v in runs["got4"]["arrays"].items()
                  if path.startswith(f"{SAVED}.params.tower.")},
    }, rtol=0, atol=0)
    assert got2["cases"]["ws2"]["state_sha256"] == runs["got4"]["cases"][SAVED]["state_sha256"]


def test_jax_checkpoint_loads_at_world_size_four(runs):
    _assert_params(runs["got4"]["arrays"], "jax-checkpoint.params", runs["want"]["jax-checkpoint"]["params"],
                   rtol=0, atol=0)


def test_sharded_serving_matches_jax(runs):
    """The port's (2, 2) ranks serve the JAX (2, 2) mesh's lists, scores to
    1e-5, on every rank alike."""
    want_ids, want_vals = runs["want"]["serve"]
    arrays = runs["got4"]["arrays"]
    np.testing.assert_array_equal(arrays["serve.chunk.ids"], want_ids)
    np.testing.assert_allclose(arrays["serve.chunk.vals"], want_vals, rtol=1e-5, atol=0)
    assert len(set(runs["got4"]["cases"]["serve"]["recommend"]["sha256"])) == 1
