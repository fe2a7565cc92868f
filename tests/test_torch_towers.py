"""The port's EWMA, GRU and attention towers against the JAX package's, on
the CPU.

One seeded numpy input and numpy parameters (every leaf drawn, so no
gradient is trivially zero) go through ``sbr_rs_tpu.models.towers`` and
``sbr_rs_tpu_torch.models.towers``: the forward agrees within rtol 1e-5 /
atol 1e-6, and the gradients of a seeded weighted sum of the output with
respect to ``x`` and every parameter leaf agree with ``jax.grad`` within
rtol 1e-4 (atol 1e-5 for entries that nearly cancel). Plain rows and packed
rows (``starts``); EWMA at T = 37 (a padded block) and T = 16 (whole
blocks); attention with 2 heads and 2 layers, inside and beyond its
position table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbr_rs_tpu.models import towers as jax_towers
from sbr_rs_tpu_torch.models import towers
from sbr_rs_tpu_torch.utils.convert import params_from_numpy
from sbr_rs_tpu_torch.utils.tree import flatten

B, D = 3, 8
HEADS, LAYERS, MAX_LEN = 2, 2, 10


def _params(name, rng):
    """Numpy parameters of tower ``name`` in the JAX package's tree."""
    def normal(*shape, scale=0.3):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    if name == "ewma":
        return {"alpha": normal(D, scale=1.0)}
    if name == "gru":
        return {"w_x": normal(D, 3 * D), "w_h": normal(D, 3 * D), "b": normal(3 * D, scale=0.1)}

    def norm():
        return {"scale": 1.0 + normal(D, scale=0.1), "bias": normal(D, scale=0.1)}

    layers = [
        {
            "ln1": norm(), "w_qkv": normal(D, 3 * D), "w_o": normal(D, D), "ln2": norm(),
            "w_f1": normal(D, D), "b_f1": normal(D, scale=0.1), "w_f2": normal(D, D),
            "b_f2": normal(D, scale=0.1),
        }
        for _ in range(LAYERS)
    ]
    return {"pos": normal(MAX_LEN, D), "layers": layers, "ln_f": norm()}


def _applies(name):
    """(JAX tower, port tower) as ``f(params, x, starts)``."""
    if name == "attention":
        return (
            functools.partial(jax_towers.attention_apply, num_heads=HEADS),
            functools.partial(towers.attention_apply, num_heads=HEADS),
        )
    return getattr(jax_towers, f"{name}_apply"), getattr(towers, f"{name}_apply")


def _case(name, t, packed, seed=0):
    rng = np.random.default_rng(seed)
    params = _params(name, rng)
    x = rng.normal(size=(B, t, D)).astype(np.float32)
    starts = (rng.random((B, t)) < 0.25).astype(np.float32) if packed else None
    if packed:
        starts[0, 0] = 0.0  # row position 0 begins a window even unmarked
    weights = rng.normal(size=(B, t, D)).astype(np.float32)
    return params, x, starts, weights


CASES = [
    ("ewma", 37, False), ("ewma", 37, True), ("ewma", 16, False), ("ewma", 16, True),
    ("gru", 12, False), ("gru", 12, True),
    ("attention", 7, False), ("attention", 7, True),  # inside the position table
    ("attention", 13, False), ("attention", 13, True),  # T > max_len: clamped positions
]


def _jax_run(name, params, x, starts, weights):
    jax_apply, _ = _applies(name)
    s = None if starts is None else jnp.asarray(starts)

    def loss(p, xx):
        return jnp.sum(jnp.asarray(weights) * jax_apply(p, xx, starts=s))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out = np.asarray(jax_apply(jp, jnp.asarray(x), starts=s))
    g_params, g_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return out, [np.asarray(g) for g in jax.tree_util.tree_leaves(g_params)], np.asarray(g_x)


def _port_run(name, params, x, starts, weights):
    _, port_apply = _applies(name)
    tree = params_from_numpy(params, "cpu")
    leaves = [v.requires_grad_() for _, v in flatten(tree)]
    xt = torch.from_numpy(x).requires_grad_()
    s = None if starts is None else torch.from_numpy(starts)
    out = port_apply(tree, xt, starts=s)
    (torch.from_numpy(weights) * out).sum().backward()
    return out.detach().numpy(), [v.grad.numpy() for v in leaves], xt.grad.numpy()


@pytest.mark.parametrize("name, t, packed", CASES)
def test_forward_matches_jax(name, t, packed):
    params, x, starts, weights = _case(name, t, packed)
    _, port_apply = _applies(name)
    s = None if starts is None else torch.from_numpy(starts)
    with torch.no_grad():
        got = port_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), starts=s).numpy()
    want, _, _ = _jax_run(name, params, x, starts, weights)
    assert got.shape == want.shape == (B, t, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name, t, packed", CASES)
def test_gradients_match_jax(name, t, packed):
    params, x, starts, weights = _case(name, t, packed, seed=1)
    out, g_leaves, g_x = _port_run(name, params, x, starts, weights)
    want_out, want_leaves, want_x = _jax_run(name, params, x, starts, weights)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_x, want_x, rtol=1e-4, atol=1e-5)
    paths = [p for p, _ in flatten(params)]
    assert len(g_leaves) == len(want_leaves) == len(paths)
    for path, got, want in zip(paths, g_leaves, want_leaves):
        assert np.abs(want).max() > 0, path  # every leaf is exercised
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=path)


def test_packed_rows_are_separate_sequences():
    """A packed row equals its windows run as separate rows, for each tower
    (positions restart, carries reset, attention stays in its window)."""
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(1, 5, D)), rng.normal(size=(1, 6, D))
    packed = torch.from_numpy(np.concatenate([a, b], axis=1).astype(np.float32))
    starts = torch.zeros((1, 11))
    starts[0, 5] = 1.0
    for name in ("ewma", "gru", "attention"):
        tree = params_from_numpy(_params(name, rng), "cpu")
        _, apply = _applies(name)
        with torch.no_grad():
            got = apply(tree, packed, starts=starts)
            sep = [apply(tree, torch.from_numpy(w.astype(np.float32))) for w in (a, b)]
        np.testing.assert_allclose(got.numpy(), torch.cat(sep, dim=1).numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["lstm_normal", "lstm_coupled", "gru", "ewma", "attention"])
def test_init_matches_jax_layout(name):
    """The port's initial tower has the JAX package's paths, shapes and
    scales (each Glorot leaf's std within 15 % of the JAX formula's)."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    dim = 32
    if name.startswith("lstm"):
        coupled = name.endswith("coupled")
        port = towers.init_lstm(gen, dim, coupled, torch.device("cpu"))
        ref = jax_towers.init_lstm(key, dim, coupled)
    elif name == "gru":
        port, ref = towers.init_gru(gen, dim, torch.device("cpu")), jax_towers.init_gru(key, dim)
    elif name == "ewma":
        port = towers.init_ewma(gen, dim, torch.device("cpu"), alpha_init=2.0)
        ref = jax_towers.init_ewma(key, dim, alpha_init=2.0)
    else:
        port = towers.init_attention(gen, dim, 16, 2, 4, torch.device("cpu"))
        ref = jax_towers.init_attention(key, dim, 16, num_layers=2, num_heads=4)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    pairs = flatten(port)
    assert len(pairs) == len(ref_leaves)
    for (path, got), want in zip(pairs, ref_leaves):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32, path
        if want.std() == 0:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        else:
            assert abs(float(got.std()) / float(want.std()) - 1) < 0.15, path


def test_attention_heads_must_divide_dim():
    with pytest.raises(ValueError):
        towers.init_attention(torch.Generator(), 10, 8, 1, 3, torch.device("cpu"))
