"""The port's LSTM backward against the JAX package's, on the CPU.

The same seeded numpy inputs go through the Pallas backward kernel in
interpret mode (``_bwd_pallas``) and ``jax.vjp`` of the ``lax.scan`` tower,
and through the port's ``lstm_bwd_plain`` and ``lstm_bwd`` (which runs the
plain loop for CPU tensors). The gradients of ``LSTMFunction`` (through
``lstm_apply_kernel``) are held against PyTorch's autograd through the plain
``towers.lstm_apply`` loop. Tolerance 1e-5 absolute: f32 throughout, sums
taken in another order.
"""

import jax
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


def _case(shape, coupled, with_starts, seed=0):
    """Parameters, x [B, T, D], starts [B, T] or None, and an upstream
    gradient g [B, T, D]."""
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
    g = rng.normal(size=(b, t, d)).astype(np.float32)
    return params, x, starts, g


def _time_major(params, x, starts):
    """xz [T, B, G*D] and keep [T, B, 1] as numpy, as the towers build them."""
    xz = np.einsum("btd,de->tbe", x, params["w_x"]) + params["b"]
    if starts is None:
        keep = np.ones(x.shape[1::-1] + (1,), np.float32)
    else:
        keep = (1.0 - starts).T[..., None]
    return xz.astype(np.float32), keep.astype(np.float32)


@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_bwd_plain_matches_pallas_and_vjp(shape, coupled, with_starts):
    params, x, starts, g = _case(shape, coupled, with_starts)
    xz, keep = _time_major(params, x, starts)
    hidden, cell = lstm_kernels.lstm_fwd_plain(
        torch.from_numpy(xz), torch.from_numpy(params["w_h"]), torch.from_numpy(keep), coupled
    )
    g_tm = np.ascontiguousarray(g.transpose(1, 0, 2))
    with pltpu.force_tpu_interpret_mode():
        want_dxz, want_dwh = pallas_lstm._bwd_pallas(
            jnp.asarray(xz), jnp.asarray(params["w_h"]), jnp.asarray(hidden.numpy()),
            jnp.asarray(cell.numpy()), jnp.asarray(g_tm), jnp.asarray(keep), coupled=coupled,
        )
    args = (
        torch.from_numpy(xz), torch.from_numpy(params["w_h"]), hidden, cell,
        torch.from_numpy(g_tm), torch.from_numpy(keep), coupled,
    )
    for fn in (lstm_kernels.lstm_bwd_plain, lstm_kernels.lstm_bwd):
        dxz, dwh = fn(*args)
        np.testing.assert_allclose(dxz.numpy(), np.asarray(want_dxz), atol=ATOL, rtol=0)
        np.testing.assert_allclose(dwh.numpy(), np.asarray(want_dwh), atol=ATOL, rtol=0)

    # The same gradients through jax.vjp of the scan tower: dW_h directly,
    # dxz through the projection (dx = dxz @ w_x^T, db = sum of dxz).
    js = None if starts is None else jnp.asarray(starts)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, vjp = jax.vjp(lambda p, xx: jax_towers.lstm_apply(p, xx, coupled=coupled, starts=js), jp, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    dxz, dwh = lstm_kernels.lstm_bwd_plain(*args)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(dp["w_h"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dxz.sum(dim=(0, 1)).numpy(), np.asarray(dp["b"]), atol=ATOL, rtol=0)
    dx_port = torch.einsum("tbe,de->btd", dxz, torch.from_numpy(params["w_x"]))
    np.testing.assert_allclose(dx_port.numpy(), np.asarray(dx), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_starts", [False, True])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_lstm_function_grads_match_autograd_of_the_plain_loop(shape, coupled, with_starts):
    params, x, starts, g = _case(shape, coupled, with_starts, seed=1)
    ts = None if starts is None else torch.from_numpy(starts)

    def grads(tower):
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        xx = torch.from_numpy(x).requires_grad_()
        out = tower(p, xx, coupled, ts)
        names = ("w_x", "w_h", "b")
        got = torch.autograd.grad(out, [p[n] for n in names] + [xx], torch.from_numpy(g))
        return out.detach(), dict(zip(names + ("x",), got))

    out_k, got = grads(lstm_kernels.lstm_apply_kernel)
    out_p, want = grads(towers.lstm_apply)
    np.testing.assert_allclose(out_k.numpy(), out_p.numpy(), atol=ATOL, rtol=0)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=ATOL, rtol=0, err_msg=name)


def test_lstm_apply_kernel_saves_nothing_without_grad():
    params, x, _, _ = _case((3, 4, 8), False, False)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    with torch.no_grad():
        out = lstm_kernels.lstm_apply_kernel(p, torch.from_numpy(x), False)
    assert out.grad_fn is None
    out = lstm_kernels.lstm_apply_kernel(p, torch.from_numpy(x), False)
    assert out.grad_fn is not None
