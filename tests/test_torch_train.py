"""The port's training step and its parts against the JAX package's, on the
CPU: losses, WARP selection, the dense optimizers and whole steps of
``make_train_step``, fed the same parameters, batches and candidates (the
JAX step's own draws, recovered from its key as the golden engine test
does).

Tolerances: elementwise parts 1e-6 (f32, same formula). Steps: loss rtol
1e-5; parameters rtol 2e-4, atol 1e-3, because Adagrad's g / sqrt(g^2 + eps)
amplifies the association noise of scatter sums on nearly cancelling rows
(as in ``tests/test_engine_golden.py``).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sbr_rs_tpu.models import Loss as JLoss
from sbr_rs_tpu.models import Optimizer as JOptimizer
from sbr_rs_tpu.models import engine as jax_engine
from sbr_rs_tpu.models import towers as jax_towers
from sbr_rs_tpu.ops import losses as jax_losses
from sbr_rs_tpu.ops import optimizers as jax_opt
from sbr_rs_tpu.ops import sampling as jax_sampling
from sbr_rs_tpu_torch.models import Loss, Optimizer, engine
from sbr_rs_tpu_torch.ops import losses, optimizers, sampling
from sbr_rs_tpu_torch.ops.lstm_kernels import lstm_apply_kernel
from sbr_rs_tpu_torch.utils.convert import params_from_numpy

RTOL, ATOL = 2e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("loss", list(Loss))
def test_pairwise_loss(loss):
    rng = np.random.default_rng(0)
    pos, neg = rng.normal(size=(2, 7, 9)).astype(np.float32) * 2
    want = jax_losses.pairwise_loss(JLoss(loss.value), jnp.asarray(pos), jnp.asarray(neg))
    got = losses.pairwise_loss(loss, _t(pos), _t(neg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_warp_select_and_onehot():
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(6, 11)).astype(np.float32) * 2
    cand = rng.normal(size=(6, 11, 5)).astype(np.float32) * 2
    cand[0, :, :] = -10.0  # nothing violates: the last draw
    cand[1, :, 2:] = 10.0  # the first violator is not the last
    want = np.asarray(jax_sampling.warp_select(jnp.asarray(pos), jnp.asarray(cand)))
    got = sampling.warp_select(_t(pos), _t(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_oh = np.asarray(jax_sampling.warp_select_onehot(jnp.asarray(pos), jnp.asarray(cand)))
    got_oh = sampling.warp_select_onehot(_t(pos), _t(cand)).numpy()
    np.testing.assert_array_equal(got_oh, want_oh)
    np.testing.assert_array_equal(got_oh.argmax(-1), want)
    assert sampling.WARP_CANDIDATES == jax_sampling.WARP_CANDIDATES


@pytest.mark.parametrize("kind", list(Optimizer))
def test_dense_update(kind):
    rng = np.random.default_rng(2)
    param, grad = rng.normal(size=(2, 8, 12)).astype(np.float32)
    jkind = JOptimizer(kind.value)
    jstate = jax_opt.init_state(jkind, jnp.asarray(param))
    state = optimizers.init_state(kind, _t(param))
    jp, p = jnp.asarray(param), _t(param).clone()
    for step in range(3):
        g = grad * (step + 1)
        jp, jstate = jax_opt.dense_update(jkind, 0.05, 0.01, jp, jstate, jnp.asarray(g), jnp.int32(step))
        p, state = optimizers.dense_update(kind, 0.05, 0.01, p, state, _t(g), step)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    for name in state:
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("with_bias_mask", [False, True])
@pytest.mark.parametrize("kind", list(Optimizer))
def test_dense_row_update(kind, with_bias_mask, dtype):
    rng = np.random.default_rng(3)
    n, c = 30, 9
    table = rng.normal(size=(n, c)).astype(dtype)
    touched = rng.random(n) < 0.5
    bias_touched = touched & (rng.random(n) < 0.5) if with_bias_mask else None
    grad = (rng.normal(size=(n, c)) * touched[:, None]).astype(np.float32)
    jkind = JOptimizer(kind.value)
    jt = jnp.asarray(table)
    jstate = jax_opt.init_state(jkind, jt)
    pt = params_from_numpy({"item_table": table, "tower": {}}, "cpu")["item_table"]
    state = optimizers.init_state(kind, pt)
    for step in range(2):
        jt, jstate = jax_opt.dense_row_update(
            jkind, 0.1, 0.02, jt, jstate, jnp.asarray(grad), jnp.asarray(touched), jnp.int32(step),
            bias_touched=None if bias_touched is None else jnp.asarray(bias_touched),
        )
        pt, state = optimizers.dense_row_update(
            kind, 0.1, 0.02, pt, state, _t(grad), _t(touched), step,
            bias_touched=None if bias_touched is None else _t(bias_touched),
        )
    assert pt.dtype == (torch.bfloat16 if dtype is ml_dtypes.bfloat16 else torch.float32)
    tol = 1e-2 if dtype is ml_dtypes.bfloat16 else 1e-6  # one bf16 ulp at |w| ~ 2
    np.testing.assert_allclose(
        pt.to(torch.float32).numpy(), np.asarray(jt).astype(np.float32), atol=tol, rtol=tol
    )
    for name in state:
        np.testing.assert_allclose(
            state[name].to(torch.float32).numpy(), np.asarray(jstate[name]).astype(np.float32),
            atol=tol, rtol=tol,
        )


def _identity(tower_params, x, starts=None):
    return x


def _towers(name):
    """(JAX tower, port tower, coupled or None)."""
    if name == "identity":
        return _identity, _identity, None
    coupled = name == "lstm_coupled"
    return (
        functools.partial(jax_towers.lstm_apply, coupled=coupled),
        functools.partial(lstm_apply_kernel, coupled=coupled),
        coupled,
    )


def _step_case(tower_name, packed, n=23, d=8, b=4, t=5, seed=0):
    rng = np.random.default_rng(seed)
    _, _, coupled = _towers(tower_name)
    tree = {"item_table": rng.normal(size=(n, d + 1)).astype(np.float32), "tower": {}}
    if coupled is not None:
        g = 3 if coupled else 4
        tree["tower"] = {
            "w_x": (rng.normal(size=(d, g * d)) * d**-0.5).astype(np.float32),
            "w_h": (rng.normal(size=(d, g * d)) * d**-0.5).astype(np.float32),
            "b": (rng.normal(size=(g * d,)) * 0.1).astype(np.float32),
        }
    batches = []
    for _ in range(2):
        batch = {
            "stream": rng.integers(0, n, (b, t + 1)).astype(np.int32),
            "mask": (rng.random((b, t)) > 0.3).astype(np.float32),
        }
        if packed:
            starts = (rng.random((b, t)) < 0.3).astype(np.float32)
            starts[:, 0] = 1.0
            batch["starts"] = starts
        batches.append(batch)
    return tree, batches


def _run_both(tree, batches, loss, kind, tower_name, lr=0.1, l2=0.01, schedule="constant",
              total_steps=0, first_step=0):
    """Consecutive steps of both engines from the same parameters; returns
    (JAX params, JAX losses, port params, port losses)."""
    n = tree["item_table"].shape[0]
    jax_tower, port_tower, _ = _towers(tower_name)
    jcfg = jax_engine.EngineConfig(
        num_items=n, loss=JLoss(loss.value), optimizer=JOptimizer(kind.value),
        learning_rate=lr, l2_penalty=l2, lr_schedule=schedule, sparse_updates=False,
    )
    cfg = engine.EngineConfig(
        num_items=n, loss=loss, optimizer=kind, learning_rate=lr, l2_penalty=l2,
        lr_schedule=schedule, sparse_updates=False,
    )
    jstep = jax_engine.make_train_step(jcfg, jax_tower, total_steps=total_steps)
    step = engine.make_train_step(cfg, port_tower, total_steps=total_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_engine.init_opt_state(jcfg.optimizer, jparams)
    jstate["step"] = jnp.int32(first_step)
    params = params_from_numpy(tree, "cpu")
    state = engine.init_opt_state(kind, params)
    state["step"] = first_step
    k_cand = 5 if loss == Loss.WARP else 1
    jl, pl = [], []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(11 + i)
        b, t1 = batch["stream"].shape
        jparams, jstate, jloss = jstep(jparams, jstate, key, {k: jnp.asarray(v) for k, v in batch.items()})
        cand = np.asarray(jax.random.randint(key, (b, t1 - 1, k_cand), 0, n, dtype=jnp.int32))
        pbatch = {k: _t(v) for k, v in batch.items()}
        params, state, ploss = step(params, state, pbatch, _t(cand))
        assert ploss.ndim == 0
        jl.append(float(jloss))
        pl.append(float(ploss))
    assert state["step"] == first_step + len(batches)
    return jparams, jl, params, pl


def _assert_params_close(jparams, params):
    np.testing.assert_allclose(
        params["item_table"].numpy(), np.asarray(jparams["item_table"]), rtol=RTOL, atol=ATOL
    )
    for name, v in params["tower"].items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jparams["tower"][name]), rtol=RTOL, atol=ATOL, err_msg=name
        )


STEP_CASES = [
    (loss, kind, tower_name, packed)
    for loss in Loss
    for kind in Optimizer
    for tower_name in ("identity", "lstm_normal")
    for packed in (False, True)
] + [
    (Loss.WARP, Optimizer.ADAM, "lstm_coupled", True),
    (Loss.HINGE, Optimizer.ADAGRAD, "lstm_coupled", False),
]


@pytest.mark.parametrize("loss, kind, tower_name, packed", STEP_CASES)
def test_train_step_matches_jax(loss, kind, tower_name, packed):
    tree, batches = _step_case(tower_name, packed)
    jparams, jl, params, pl = _run_both(tree, batches, loss, kind, tower_name)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(jparams, params)


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine", "warmup_cosine"])
def test_lr_schedules_match_jax(schedule):
    tree, batches = _step_case("lstm_normal", False, seed=4)
    jparams, jl, params, pl = _run_both(
        tree, batches, Loss.HINGE, Optimizer.ADAGRAD, "lstm_normal", lr=0.3,
        schedule=schedule, total_steps=20, first_step=5,
    )
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(jparams, params)
    for step, want in ((0, 0.3 / 2), (5, 0.3 * 0.5 * (1 + np.cos(np.pi * 3 / 18)))):
        if schedule == "warmup_cosine":
            assert engine.scheduled_lr(0.3, schedule, step, 20) == pytest.approx(want)

