"""The port's sparse touched-row update against the JAX package's, on the
CPU: ``dedupe_rows``, ``segment_sum_grads``, ``dedupe_and_sum`` and
``sparse_update``, then whole sparse steps of ``make_train_step`` against
the JAX sparse step and against the port's own dense step, fed the same
parameters, batches and candidates.

Tolerances. Ids, orders and masks: exact. Run sums: both packages take
them as differences of a cumulative sum scanned in blocks of 128; the two
frameworks' scans may still round apart, within a few ulps of the prefix
(1e-5 here). One optimizer update from the same inputs: 1e-6 in f32;
one bf16 ulp (1e-2 at |w| ~ 2) for bf16 tables and state. Steps: loss rtol
1e-5; parameters rtol 2e-4, atol 1e-3, as ``tests/test_engine_golden.py``
(Adagrad's g / sqrt(g^2 + eps) amplifies association noise on nearly
cancelling rows).
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
from sbr_rs_tpu.ops import optimizers as jax_opt
from sbr_rs_tpu_torch.models import Loss, Optimizer, engine
from sbr_rs_tpu_torch.ops import optimizers
from sbr_rs_tpu_torch.ops.lstm_kernels import lstm_apply_kernel
from sbr_rs_tpu_torch.utils.convert import params_from_numpy

RTOL, ATOL = 2e-4, 1e-3
DTYPES = [np.float32, ml_dtypes.bfloat16]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tensor(a):
    """A numpy array (bf16 included) as a port tensor of the same dtype."""
    return params_from_numpy({"item_table": a, "tower": {}}, "cpu")["item_table"]


def _occurrences(seed, m=90, n=25, p_valid=0.8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m).astype(np.int32)
    valid = rng.random(m) < p_valid
    grads = rng.normal(size=(m, 6)).astype(np.float32)
    bias_occ = rng.random(m) < 0.5
    return idx, valid, grads, bias_occ, n


OCCURRENCES = [(0, 90, 25, 0.8), (1, 64, 500, 0.9), (2, 40, 3, 0.5), (3, 16, 10, 0.0)]


@pytest.mark.parametrize("seed, m, n, p_valid", OCCURRENCES)
def test_dedupe_rows_and_segment_sums_match_jax(seed, m, n, p_valid):
    idx, valid, grads, _, n = _occurrences(seed, m, n, p_valid)
    want = jax_opt.dedupe_rows(jnp.asarray(idx), jnp.asarray(valid), n)
    got = optimizers.dedupe_rows(_t(idx).long(), _t(valid), n)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(
        optimizers.segment_sum_grads(_t(grads), got).numpy(),
        np.asarray(jax_opt.segment_sum_grads(jnp.asarray(grads), want)), rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("seed, m, n, p_valid", OCCURRENCES)
def test_dedupe_and_sum_matches_jax(seed, m, n, p_valid):
    idx, valid, grads, bias_occ, n = _occurrences(seed, m, n, p_valid)
    jdd, jsum, jbias = jax_opt.dedupe_and_sum(
        jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(grads), jnp.asarray(bias_occ), n
    )
    dd, summed, bias_valid = optimizers.dedupe_and_sum(_t(idx).long(), _t(valid), _t(grads), _t(bias_occ), n)
    for name in ("order", "seg_id", "row_ids", "valid"):
        np.testing.assert_array_equal(getattr(dd, name).numpy(), np.asarray(getattr(jdd, name)), err_msg=name)
    live = dd.valid.numpy()
    np.testing.assert_allclose(summed.numpy()[live], np.asarray(jsum)[live], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bias_valid.numpy()[live], np.asarray(jbias)[live])
    # The layout: each touched row once, at its run's last occurrence; the
    # sentinel everywhere else.
    rows = dd.row_ids.numpy()
    assert sorted(rows[live].tolist()) == sorted(set(idx[valid].tolist()))
    assert (rows[~live] == n).all()


def _sparse_case(seed, dtype, c=7, n=30, m=50):
    """A table, its optimizer state after some history, and one step's
    deduplicated rows and sums, as numpy arrays."""
    rng = np.random.default_rng(seed)
    idx, valid, _, bias_occ, _ = _occurrences(seed, m, n)
    grads = rng.normal(size=(m, c)).astype(np.float32)
    table = rng.normal(size=(n, c)).astype(dtype)
    history = {
        "acc": (rng.random((n, c)) * 2).astype(dtype),
        "m": (rng.normal(size=(n, c)) * 0.1).astype(dtype),
        "v": (rng.random((n, c)) * 0.1).astype(dtype),
    }
    return idx, valid, grads, bias_occ, n, table, history


def _state(kind, history, to):
    names = ("acc",) if kind == Optimizer.ADAGRAD else ("m", "v")
    return {k: to(history[k]) for k in names}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_bias_mask", [False, True])
@pytest.mark.parametrize("kind", list(Optimizer))
def test_sparse_update_matches_jax(kind, with_bias_mask, dtype):
    idx, valid, grads, bias_occ, n, table, history = _sparse_case(5, dtype)
    jdd, jsum, jbias = jax_opt.dedupe_and_sum(
        jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(grads), jnp.asarray(bias_occ), n
    )
    jkind = JOptimizer(kind.value)
    jt, jstate = jnp.asarray(table), _state(kind, history, jnp.asarray)
    dd = optimizers.DedupedRows(*(_t(np.asarray(x)).long() if x.dtype != bool else _t(np.asarray(x)) for x in jdd))
    pt, state = _tensor(table), _state(kind, history, _tensor)
    for step in (0, 3):
        jt, jstate = jax_opt.sparse_update(
            jkind, 0.1, 0.02, jt, jstate, jdd, jsum, jnp.int32(step),
            bias_valid=jbias if with_bias_mask else None,
        )
        out, out_state = optimizers.sparse_update(
            kind, 0.1, 0.02, pt, state, dd, _t(np.asarray(jsum)), step,
            bias_valid=_t(np.asarray(jbias)) if with_bias_mask else None,
        )
        assert out is pt and out_state is state  # in place
    tol = 1e-2 if dtype is ml_dtypes.bfloat16 else 1e-6
    np.testing.assert_allclose(pt.float().numpy(), np.asarray(jt).astype(np.float32), rtol=tol, atol=tol)
    for name in state:
        np.testing.assert_allclose(
            state[name].float().numpy(), np.asarray(jstate[name]).astype(np.float32),
            rtol=tol, atol=tol, err_msg=name,
        )
    untouched = np.setdiff1d(np.arange(n), idx[valid])
    np.testing.assert_array_equal(pt.float().numpy()[untouched], table.astype(np.float32)[untouched])


@pytest.mark.parametrize("kind", list(Optimizer))
def test_sparse_update_of_a_vector_matches_jax(kind):
    idx, valid, grads, bias_occ, n, table, history = _sparse_case(6, np.float32, c=1)
    grads, table = grads[:, 0], table[:, 0]
    history = {k: v[:, 0] for k, v in history.items()}
    jdd = jax_opt.dedupe_rows(jnp.asarray(idx), jnp.asarray(valid), n)
    jsum = jax_opt.segment_sum_grads(jnp.asarray(grads), jdd)
    jt, jstate = jax_opt.sparse_update(
        JOptimizer(kind.value), 0.1, 0.02, jnp.asarray(table), _state(kind, history, jnp.asarray),
        jdd, jsum, jnp.int32(1),
    )
    dd = optimizers.dedupe_rows(_t(idx).long(), _t(valid), n)
    pt, state = optimizers.sparse_update(
        kind, 0.1, 0.02, _t(table), _state(kind, history, _t), dd,
        optimizers.segment_sum_grads(_t(grads)[:, None], dd)[:, 0], 1,
    )
    assert pt.shape == (n,)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)
    for name in state:
        np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), rtol=1e-6, atol=1e-6)


# -- whole steps ---------------------------------------------------------------------


def _step_case(seed, dtype=np.float32, n=23, d=8, b=4, t=5):
    rng = np.random.default_rng(seed)
    g = 4  # Normal LSTM
    tree = {
        "item_table": rng.normal(size=(n, d + 1)).astype(dtype),
        "tower": {
            "w_x": (rng.normal(size=(d, g * d)) * d**-0.5).astype(np.float32),
            "w_h": (rng.normal(size=(d, g * d)) * d**-0.5).astype(np.float32),
            "b": (rng.normal(size=(g * d,)) * 0.1).astype(np.float32),
        },
    }
    batches = []
    for _ in range(2):
        starts = (rng.random((b, t)) < 0.3).astype(np.float32)
        starts[:, 0] = 1.0
        batches.append({
            "stream": rng.integers(0, n, (b, t + 1)).astype(np.int32),
            "mask": (rng.random((b, t)) > 0.3).astype(np.float32),
            "starts": starts,
        })
    return tree, batches


def _port_steps(tree, batches, cands, loss, kind, sparse):
    n = tree["item_table"].shape[0]
    cfg = engine.EngineConfig(
        num_items=n, loss=loss, optimizer=kind, learning_rate=0.1, l2_penalty=0.01,
        sparse_updates=sparse,
    )
    step = engine.make_train_step(cfg, functools.partial(lstm_apply_kernel, coupled=False))
    params = params_from_numpy(tree, "cpu")
    state = engine.init_opt_state(kind, params)
    losses = []
    for batch, cand in zip(batches, cands):
        params, state, loss_sum = step(params, state, {k: _t(v) for k, v in batch.items()}, _t(cand))
        losses.append(float(loss_sum))
    return params, losses


def _jax_steps(tree, batches, loss, kind):
    """The JAX sparse step over the batches; returns (params, losses, the
    candidates it drew)."""
    n = tree["item_table"].shape[0]
    cfg = jax_engine.EngineConfig(
        num_items=n, loss=JLoss(loss.value), optimizer=JOptimizer(kind.value),
        learning_rate=0.1, l2_penalty=0.01, sparse_updates=True,
    )
    step = jax_engine.make_train_step(cfg, functools.partial(jax_towers.lstm_apply, coupled=False))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jax_engine.init_opt_state(cfg.optimizer, params)
    k_cand = 5 if loss == Loss.WARP else 1
    losses, cands = [], []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(11 + i)
        b, t1 = batch["stream"].shape
        params, state, loss_sum = step(params, state, key, {k: jnp.asarray(v) for k, v in batch.items()})
        cands.append(np.asarray(jax.random.randint(key, (b, t1 - 1, k_cand), 0, n, dtype=jnp.int32)))
        losses.append(float(loss_sum))
    return params, losses, cands


def _assert_params_close(params, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        params["item_table"].float().numpy(), np.asarray(want["item_table"]).astype(np.float32),
        rtol=rtol, atol=atol,
    )
    for name, v in params["tower"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want["tower"][name]), rtol=rtol, atol=atol, err_msg=name)


SPARSE_STEPS = [(loss, kind) for loss in Loss for kind in Optimizer]


@pytest.mark.parametrize("loss, kind", SPARSE_STEPS)
def test_sparse_step_matches_jax(loss, kind):
    tree, batches = _step_case(7)
    jparams, jl, cands = _jax_steps(tree, batches, loss, kind)
    params, pl = _port_steps(tree, batches, cands, loss, kind, sparse=True)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(params, jparams)


def test_sparse_step_bf16_adam_matches_jax():
    """A bf16 table and bf16 Adam moments: the lazy-Adam cast difference
    rounds alike in both packages (one bf16 ulp, 1e-2, on the table)."""
    tree, batches = _step_case(8, dtype=ml_dtypes.bfloat16)
    jparams, jl, cands = _jax_steps(tree, batches, Loss.WARP, Optimizer.ADAM)
    params, pl = _port_steps(tree, batches, cands, Loss.WARP, Optimizer.ADAM, sparse=True)
    assert params["item_table"].dtype == torch.bfloat16
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_params_close(params, jparams, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("loss, kind", SPARSE_STEPS)
def test_sparse_step_matches_dense_step(loss, kind):
    """Both table updates of the port keep the touched-rows rule: the same
    steps from the same inputs agree within the step tolerances."""
    tree, batches = _step_case(9, n=40)
    rng = np.random.default_rng(10)
    k_cand = 5 if loss == Loss.WARP else 1
    cands = [rng.integers(0, 40, (4, 5, k_cand)) for _ in batches]
    sparse, ls = _port_steps(tree, batches, cands, loss, kind, sparse=True)
    dense, ld = _port_steps(tree, batches, cands, loss, kind, sparse=False)
    np.testing.assert_allclose(ls, ld, rtol=1e-5)
    _assert_params_close(sparse, jax.tree_util.tree_map(torch.Tensor.numpy, dense))
