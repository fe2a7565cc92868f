"""The port's LSTM recurrence against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX tower (``towers.lstm_apply``,
a ``lax.scan``) and the Pallas forward kernel in interpret mode
(``lstm_apply_pallas`` / ``_fwd_pallas``), and through the port's plain
``lstm_apply``, ``lstm_fwd_plain`` and ``lstm_apply_kernel`` (which runs the
plain loop for CPU tensors). Tolerance 1e-5: f32 throughout, sums taken in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sbr_rs_tpu.models import towers as jax_towers
from sbr_rs_tpu.ops import pallas_lstm
from sbr_rs_tpu_torch.models import towers
from sbr_rs_tpu_torch.ops import lstm_kernels

ATOL = 1e-5
SHAPES = [(4, 5, 32), (9, 3, 16), (6, 8, 127)]  # (B, T, D)


def _inputs(shape, coupled, with_starts, seed=0):
    b, t, d = shape
    gates = 3 if coupled else 4
    rng = np.random.default_rng(seed)
    std = (1.0 / d) ** 0.5
    params = {
        "w_x": (rng.normal(size=(d, gates * d)) * std).astype(np.float32),
        "w_h": (rng.normal(size=(d, gates * d)) * std).astype(np.float32),
        "b": (rng.normal(size=(gates * d,)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    starts = None
    if with_starts:
        starts = (rng.random((b, t)) < 0.3).astype(np.float32)
        starts[:, 0] = 1.0
    return params, x, starts


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_apply_matches_jax(shape, coupled, with_starts):
    params, x, starts = _inputs(shape, coupled, with_starts)
    js = None if starts is None else jnp.asarray(starts)
    ts = None if starts is None else torch.from_numpy(starts)
    want = np.asarray(
        jax_towers.lstm_apply(_jax(params), jnp.asarray(x), coupled=coupled, starts=js)
    )
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(
            pallas_lstm.lstm_apply_pallas(
                _jax(params), jnp.asarray(x), coupled=coupled, starts=js
            )
        )
    got_plain = towers.lstm_apply(_torch(params), torch.from_numpy(x), coupled, ts).numpy()
    got_kernel_path = lstm_kernels.lstm_apply_kernel(
        _torch(params), torch.from_numpy(x), coupled, ts
    ).numpy()
    assert got_plain.shape == want.shape == shape
    np.testing.assert_allclose(got_plain, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_plain, want_pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_kernel_path, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_fwd_hidden_and_cell_match_pallas(shape, coupled, with_starts):
    """Time-major forward: hidden AND cell against the Pallas kernel's."""
    b, t, d = shape
    gates = 3 if coupled else 4
    params, _, starts = _inputs(shape, coupled, with_starts, seed=1)
    rng = np.random.default_rng(2)
    xz = rng.normal(size=(t, b, gates * d)).astype(np.float32)
    if starts is None:
        keep = np.ones((t, b, 1), np.float32)
    else:
        keep = (1.0 - starts).T[..., None].astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_h, want_c = pallas_lstm._fwd_pallas(
            jnp.asarray(xz), jnp.asarray(params["w_h"]), jnp.asarray(keep), coupled=coupled
        )
    args = (torch.from_numpy(xz), torch.from_numpy(params["w_h"]), torch.from_numpy(keep), coupled)
    for fn in (lstm_kernels.lstm_fwd_plain, lstm_kernels.lstm_fwd):
        got_h, got_c = fn(*args)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL, rtol=0)
