"""The EWMA, GRU and attention families' ``fit`` against the JAX package's,
on the CPU, as ``tests/test_torch_fit.py`` holds the LSTM's.

Both models start from the JAX model's weights (numpy arrays through
``load_numpy_params``) and draw the JAX fit's permutations and candidates
(the port's ``_epoch_permutation`` and ``_step_candidates`` overridden with
``permutation(fold_in(key_perm, e), n)`` and ``randint(fold_in(key_steps,
step), ...)``). After two epochs on small synthetic data the loss agrees
within rtol 1e-4 and every parameter within rtol 2e-4 / atol 1e-3 (Adagrad's
and Adam's first steps amplify the association noise of nearly cancelling
gradients). A few cases per family over dense and sparse table updates,
WARP/Hinge/BPR and Adagrad/Adam, packed and not; attention at dropout 0,
where neither package draws a mask.

BPR runs with Adam only. At the initial weights every BPR occurrence has a
gradient near sigmoid'(0) = 0.25, so an item drawn as often as a negative
as it is a positive has a bias gradient near 0, of the order of the sums'
rounding (the sparse update of both packages sums a row's gradients as
differences of a running sum, about 1e-7 of the prefix; the port's dense
step too), and Adagrad's first step (eps
1e-10) turns that rounding into updates of up to ``lr``: a GRU BPR/Adagrad
fit put 2 of 60 biases 2e-3 apart. The comparison, not either package, is
ill-conditioned there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu.models import Loss as JLoss
from sbr_rs_tpu.models import Optimizer as JOptimizer
from sbr_rs_tpu.models import attention as jax_attention
from sbr_rs_tpu.models import ewma as jax_ewma
from sbr_rs_tpu.models import gru as jax_gru
from sbr_rs_tpu_torch import datasets
from sbr_rs_tpu_torch.models import Loss, Optimizer, attention, ewma, gru
from sbr_rs_tpu_torch.utils.tree import flatten

RTOL, ATOL = 2e-4, 1e-3
NUM_ITEMS = 60
FAMILIES = {"ewma": (jax_ewma, ewma), "gru": (jax_gru, gru), "attention": (jax_attention, attention)}


def draw_like_jax(port_model, key, num_items):
    """Make the port model draw what the JAX fit from ``key`` draws."""
    _, key_fit = jax.random.split(key)
    key_steps, key_perm = jax.random.split(key_fit)

    def permutation(epoch, n):
        perm = jax.random.permutation(jax.random.fold_in(key_perm, epoch), n)
        return torch.from_numpy(np.asarray(perm).astype(np.int64))

    def candidates(step, shape):
        c = jax.random.randint(jax.random.fold_in(key_steps, step), shape, 0, num_items, dtype=jnp.int32)
        return torch.from_numpy(np.asarray(c).astype(np.int64))

    port_model._epoch_permutation = permutation
    port_model._step_candidates = candidates


CASES = [
    ("ewma", Loss.WARP, Optimizer.ADAGRAD, True, False),
    ("ewma", Loss.HINGE, Optimizer.ADAM, False, True),
    ("gru", Loss.WARP, Optimizer.ADAM, True, False),
    ("gru", Loss.BPR, Optimizer.ADAM, False, True),
    ("gru", Loss.HINGE, Optimizer.ADAGRAD, True, True),
    ("attention", Loss.WARP, Optimizer.ADAM, True, False),
    ("attention", Loss.HINGE, Optimizer.ADAGRAD, False, True),
    ("attention", Loss.BPR, Optimizer.ADAM, True, True),
]


@pytest.mark.parametrize("name, loss, kind, packed, sparse", CASES)
def test_fit_matches_jax(name, loss, kind, packed, sparse):
    jax_mod, mod = FAMILIES[name]
    jhp = (
        jax_mod.Hyperparameters(NUM_ITEMS, 8)
        .embedding_dim(8)
        .learning_rate(0.05)
        .l2_penalty(1e-3)
        .loss(JLoss(loss.value))
        .optimizer(JOptimizer(kind.value))
        .num_epochs(2)
        .batch_size(16)
        .packed(packed)
        .sparse_updates(sparse)
        .lr_schedule("cosine")
        .from_seed(3)
    )
    if name == "attention":
        jhp = jhp.num_layers(2).num_heads(2)
    if name == "ewma":
        jhp = jhp.alpha_init(2.0)
    jm = jhp.build()
    pm = mod.Hyperparameters.from_dict(jm.hyper.to_dict()).build("cpu")
    assert pm._engine_config().sparse_updates is sparse
    pm.load_numpy_params(jax.tree_util.tree_map(np.asarray, jm._params))
    draw_like_jax(pm, jm._key, NUM_ITEMS)
    dropout_state = pm._dropout_generator.get_state()

    want = jm.fit(jax_datasets.synthetic_interactions(40, NUM_ITEMS, 15, rng=0).to_compressed())
    got = pm.fit(datasets.synthetic_interactions(40, NUM_ITEMS, 15, rng=0).to_compressed())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(pm.history.epoch_losses, jm.history.epoch_losses, rtol=1e-4)
    jp = jax.tree_util.tree_map(np.asarray, jm._params)
    np.testing.assert_allclose(pm.item_embeddings, jp["item_table"][:, :-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.item_biases, jp["item_table"][:, -1], rtol=RTOL, atol=ATOL)
    pairs = flatten(pm._params["tower"])
    want_leaves = jax.tree_util.tree_leaves(jp["tower"])
    assert len(pairs) == len(want_leaves)
    for (path, v), w in zip(pairs, want_leaves):
        np.testing.assert_allclose(v.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=path)
    # Nothing drew from the dropout stream (dropout 0, or no dropout at all).
    assert torch.equal(pm._dropout_generator.get_state(), dropout_state)
