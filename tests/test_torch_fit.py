"""The port's ``fit`` against the JAX package's, on the CPU.

Both models start from the same weights (the JAX model's, carried across as
numpy arrays) and draw the same randomness: the port's
``_epoch_permutation`` and ``_step_candidates`` are overridden with the JAX
fit's own draws, ``permutation(fold_in(key_perm, e), n)`` and
``randint(fold_in(key_steps, e * num_batches + i), ...)`` from the model's
key. After two epochs on small synthetic data the returned loss agrees
within rtol 1e-4 and the parameters within rtol 2e-4, atol 1e-3 (Adagrad's
g / sqrt(g^2 + eps) amplifies the association noise of nearly cancelling
rows, as in ``tests/test_engine_golden.py``); the trained models then
recommend alike. Both table updates are held so: the dense one and the
sparse touched-rows one. The JAX fits are few and tiny: each compiles a
whole-fit program here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbr_rs_tpu import datasets as jax_datasets
from sbr_rs_tpu.models import Loss as JLoss
from sbr_rs_tpu.models import Optimizer as JOptimizer
from sbr_rs_tpu.models import lstm as jax_lstm
from sbr_rs_tpu_torch import data, datasets
from sbr_rs_tpu_torch.errors import NoInteractions, NonFiniteLoss
from sbr_rs_tpu_torch.models import Loss, Optimizer, lstm

RTOL, ATOL = 2e-4, 1e-3
NUM_ITEMS = 60


def _data():
    return datasets.synthetic_interactions(40, NUM_ITEMS, 15, rng=0).to_compressed()


def _hyper(variant, loss, kind, packed, sparse, epochs=2):
    return (
        jax_lstm.Hyperparameters(NUM_ITEMS, 8)
        .embedding_dim(8)
        .learning_rate(0.1)
        .l2_penalty(1e-3)
        .loss(JLoss(loss.value))
        .optimizer(JOptimizer(kind.value))
        .lstm_variant(jax_lstm.LSTMVariant(variant.value))
        .num_epochs(epochs)
        .batch_size(16)
        .packed(packed)
        .sparse_updates(sparse)
        .from_seed(3)
    )


def _draw_like_jax(port_model, key):
    """Make the port model draw what the JAX fit from ``key`` draws."""
    _, key_fit = jax.random.split(key)
    key_steps, key_perm = jax.random.split(key_fit)

    def permutation(epoch, n):
        perm = jax.random.permutation(jax.random.fold_in(key_perm, epoch), n)
        return torch.from_numpy(np.asarray(perm).astype(np.int64))

    def candidates(step, shape):
        c = jax.random.randint(jax.random.fold_in(key_steps, step), shape, 0, NUM_ITEMS, dtype=jnp.int32)
        return torch.from_numpy(np.asarray(c).astype(np.int64))

    port_model._epoch_permutation = permutation
    port_model._step_candidates = candidates


def _numpy_params(model):
    return jax.tree_util.tree_map(np.asarray, model._params)


@pytest.mark.parametrize(
    "variant, loss, kind, packed, sparse",
    [
        (lstm.LSTMVariant.NORMAL, Loss.WARP, Optimizer.ADAGRAD, True, False),
        (lstm.LSTMVariant.COUPLED, Loss.HINGE, Optimizer.ADAM, False, False),
        (lstm.LSTMVariant.NORMAL, Loss.WARP, Optimizer.ADAGRAD, True, True),
        (lstm.LSTMVariant.COUPLED, Loss.BPR, Optimizer.ADAM, False, True),
    ],
)
def test_fit_matches_jax(variant, loss, kind, packed, sparse):
    mat = _data()
    jmat = jax_datasets.synthetic_interactions(40, NUM_ITEMS, 15, rng=0).to_compressed()
    jm = _hyper(variant, loss, kind, packed, sparse).build()
    pm = lstm.Hyperparameters.from_dict(jm.hyper.to_dict()).build("cpu")
    assert pm._engine_config().sparse_updates is sparse
    pm.load_numpy_params(_numpy_params(jm))
    _draw_like_jax(pm, jm._key)

    want = jm.fit(jmat)
    got = pm.fit(mat)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert pm.history.examples_per_epoch == jm.history.examples_per_epoch
    np.testing.assert_allclose(pm.history.epoch_losses, jm.history.epoch_losses, rtol=1e-4)
    jp = _numpy_params(jm)
    np.testing.assert_allclose(pm.item_embeddings, jp["item_table"][:, :-1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.item_biases, jp["item_table"][:, -1], rtol=RTOL, atol=ATOL)
    for name, v in pm._params["tower"].items():
        np.testing.assert_allclose(v.numpy(), jp["tower"][name], rtol=RTOL, atol=ATOL, err_msg=name)

    # The trained models recommend alike: the scores rank by rank, and the
    # ids wherever the JAX scores are not near-tied.
    rng = np.random.default_rng(5)
    hs = [rng.integers(0, NUM_ITEMS, rng.integers(1, 10)).tolist() for _ in range(16)]
    ids_p, s_p = pm.recommend_batch(hs, k=5, return_scores=True)
    ids_j, s_j = jm.recommend_batch(hs, k=5, return_scores=True)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-3, atol=5e-3)
    gap = np.diff(s_j, axis=1, prepend=np.inf, append=-np.inf)
    apart = (np.abs(gap[:, :-1]) > 1e-2) & (np.abs(gap[:, 1:]) > 1e-2)
    np.testing.assert_array_equal(np.asarray(ids_p)[apart], np.asarray(ids_j)[apart])


def _port_model(**kw):
    hp = (
        lstm.Hyperparameters(NUM_ITEMS, 8)
        .embedding_dim(8)
        .learning_rate(kw.get("lr", 0.1))
        .loss(Loss.HINGE)
        .optimizer(Optimizer.ADAGRAD)
        .num_epochs(kw.get("epochs", 1))
        .batch_size(16)
        .from_seed(1)
    )
    return hp.build("cpu")


def test_fit_errors():
    with pytest.raises(NoInteractions):
        _port_model().fit(data.Interactions(100, NUM_ITEMS).to_compressed())
    with pytest.raises(NonFiniteLoss):
        _port_model(lr=1e38, epochs=2).fit(_data())


def test_history_and_second_fit_continue_from_the_parameters():
    mat = _data()
    model = _port_model(epochs=2)
    first = model.fit(mat)
    h = model.history
    windows = data.to_streams(data.extract_padded_windows(mat, 8))
    assert h.examples_per_epoch == windows.num_examples
    assert h.num_epochs == 2 and h.epoch_losses.shape == (2,)
    assert h.wall_s > 0 and h.examples_per_sec > 0
    assert first == pytest.approx(h.mean_loss, rel=1e-6)
    table = model._params["item_table"].clone()
    later = model.fit(mat)
    assert later < first  # continues from the trained parameters
    assert not torch.equal(model._params["item_table"], table)


def test_clone_after_fit_draws_the_same():
    mat = _data()
    model = _port_model()
    model.fit(mat)
    twin = model.clone()
    assert torch.equal(twin._train_generator.get_state(), model._train_generator.get_state())
    a, b = model.fit(mat), twin.fit(mat)
    assert a == b
    assert torch.equal(model._params["item_table"], twin._params["item_table"])
    for name, v in model._params["tower"].items():
        assert torch.equal(v, twin._params["tower"][name])


def test_training_generator_carries_across_fits():
    mat = _data()
    model = _port_model()
    fresh = _port_model()
    model.fit(mat)
    assert not torch.equal(model._train_generator.get_state(), fresh._train_generator.get_state())
    model.fit(mat)
    fresh.fit(mat)
    fresh.fit(mat)
    assert torch.equal(model._params["item_table"], fresh._params["item_table"])
