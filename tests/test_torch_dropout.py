"""Attention's train-time dropout in the port, on the CPU.

The masks come from the model's own dropout generator, so they cannot equal
the JAX package's threefry draws; parity is held at dropout 0 elsewhere
(``tests/test_torch_family_fit.py``). Here:

* at dropout 0 a fit draws nothing from the dropout generator;
* with the masks injected, :func:`attention_apply` equals a numpy float64
  computation of the same masked forward (input, then each layer's two
  residual branches, in that order);
* the keep rate of a large draw lies within 4 sigma of ``1 - p``;
* a dropout fit draws the same permutations and candidates as a dropout-0
  fit from the same seed, moves only the dropout generator besides, and
  serves deterministically; ``clone`` carries the dropout stream.
"""

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch import datasets
from sbr_rs_tpu_torch.models import Loss, Optimizer, attention, towers
from sbr_rs_tpu_torch.utils.convert import params_from_numpy

D, HEADS, LAYERS, MAX_LEN = 8, 2, 2, 6


def _model(rate, seed=5):
    return (
        attention.Hyperparameters(40, 8)
        .embedding_dim(16)
        .num_heads(2)
        .dropout(rate)
        .learning_rate(0.05)
        .loss(Loss.WARP)
        .optimizer(Optimizer.ADAM)
        .num_epochs(2)
        .batch_size(16)
        .packed(True)
        .from_seed(seed)
        .build("cpu")
    )


def _data():
    return datasets.synthetic_interactions(30, 40, 12, rng=1).to_compressed()


def _recording(model):
    """Record the permutations and candidates the model's fits draw."""
    drawn = []
    perm, cand = model._epoch_permutation, model._step_candidates
    model._epoch_permutation = lambda *a: drawn.append(perm(*a)) or drawn[-1]
    model._step_candidates = lambda *a: drawn.append(cand(*a)) or drawn[-1]
    return drawn


def test_dropout_zero_draws_nothing_from_its_generator():
    model = _model(0.0)
    state = model._dropout_generator.get_state()
    train_state = model._train_generator.get_state()
    assert np.isfinite(model.fit(_data()))
    assert torch.equal(model._dropout_generator.get_state(), state)
    assert not torch.equal(model._train_generator.get_state(), train_state)


def test_dropout_fit_keeps_the_other_draws_and_serves_deterministically():
    plain, dropped = _model(0.0), _model(0.3)
    state = dropped._dropout_generator.get_state()
    drawn_plain, drawn_dropped = _recording(plain), _recording(dropped)
    loss_plain, loss_dropped = plain.fit(_data()), dropped.fit(_data())
    assert np.isfinite(loss_dropped) and loss_dropped != loss_plain
    assert len(drawn_plain) == len(drawn_dropped) > 0
    assert all(torch.equal(a, b) for a, b in zip(drawn_plain, drawn_dropped))
    assert torch.equal(plain._train_generator.get_state(), dropped._train_generator.get_state())
    assert not torch.equal(dropped._dropout_generator.get_state(), state)
    hs = [[1, 2, 3], [4, 5], [7]]
    reps = [u.user_embedding for u in dropped.user_representations(hs)]
    assert all(np.array_equal(a, u.user_embedding) for a, u in zip(reps, dropped.user_representations(hs)))
    assert dropped.recommend_batch(hs, k=5) == dropped.recommend_batch(hs, k=5)
    # A clone continues the dropout stream where the model is.
    twin = dropped.clone()
    assert dropped.fit(_data()) == twin.fit(_data())


def test_keep_rate_within_four_sigma():
    p = 0.2
    n = 1_000_000
    gen = torch.Generator().manual_seed(0)
    kept = float(towers.dropout_mask(gen, (n,), 1.0 - p, torch.device("cpu")).float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept - (1 - p)) <= 4 * sigma


def _numpy_masked_forward(p, x, starts, masks, rate):
    """The masked forward in float64: x + positions, dropped; pre-LN layers
    with each residual branch dropped; a final layer norm."""
    keep = 1.0 - rate
    masks = iter(masks)

    def drop(v):
        return np.where(next(masks), v / keep, 0.0)

    def ln(q, v):
        mu = v.mean(-1, keepdims=True)
        var = ((v - mu) ** 2).mean(-1, keepdims=True)
        return (v - mu) / np.sqrt(var + 1e-6) * q["scale"] + q["bias"]

    b_, t_, d = x.shape
    hd = d // HEADS
    s = starts.copy()
    s[:, 0] = 1.0
    win = np.cumsum(s, axis=1)
    t_idx = np.arange(t_)
    start_pos = np.maximum.accumulate(np.where(s > 0, t_idx, 0), axis=1)
    pos_idx = np.clip(t_idx - start_pos, 0, MAX_LEN - 1)
    h = drop(x + p["pos"][pos_idx])
    allowed = (win[:, :, None] == win[:, None, :]) & (t_idx[None, :] <= t_idx[:, None])[None]
    for layer in p["layers"]:
        qkv = (ln(layer["ln1"], h) @ layer["w_qkv"]).reshape(b_, t_, 3, HEADS, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = np.einsum("bihd,bjhd->bhij", q, k) * hd**-0.5
        logits = np.where(allowed[:, None], logits, -1e9)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        ctx = np.einsum("bhij,bjhd->bihd", e / e.sum(-1, keepdims=True), v).reshape(b_, t_, d)
        h = h + drop(ctx @ layer["w_o"])
        f = np.maximum(ln(layer["ln2"], h) @ layer["w_f1"] + layer["b_f1"], 0.0)
        h = h + drop(f @ layer["w_f2"] + layer["b_f2"])
    return ln(p["ln_f"], h)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_injected_masks_match_a_numpy_forward(rate, monkeypatch):
    rng = np.random.default_rng(3)
    b_, t_ = 3, 9

    def normal(*shape, scale=0.3):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    def norm():
        return {"scale": 1.0 + normal(D, scale=0.1), "bias": normal(D, scale=0.1)}

    params = {
        "pos": normal(MAX_LEN, D),
        "layers": [{"ln1": norm(), "w_qkv": normal(D, 3 * D), "w_o": normal(D, D), "ln2": norm(),
                    "w_f1": normal(D, D), "b_f1": normal(D), "w_f2": normal(D, D), "b_f2": normal(D)}
                   for _ in range(LAYERS)],
        "ln_f": norm(),
    }
    x = normal(b_, t_, D, scale=1.0)
    starts = (rng.random((b_, t_)) < 0.3).astype(np.float32)
    masks = [rng.random((b_, t_, D)) >= rate for _ in range(1 + 2 * LAYERS)]
    handed = iter(masks)
    calls = []

    def injected(generator, shape, keep, device):
        calls.append((tuple(shape), keep))
        return torch.from_numpy(next(handed))

    monkeypatch.setattr(towers, "dropout_mask", injected)
    with torch.no_grad():
        got = towers.attention_apply(
            params_from_numpy(params, "cpu"), torch.from_numpy(x), num_heads=HEADS, dropout=rate,
            starts=torch.from_numpy(starts), generator=torch.Generator(),
        ).numpy()
    assert calls == [((b_, t_, D), 1.0 - rate)] * (1 + 2 * LAYERS)
    want = _numpy_masked_forward(params, x.astype(np.float64), starts, masks, rate)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # Without a generator (serving) nothing is drawn and nothing dropped.
    calls.clear()
    with torch.no_grad():
        towers.attention_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x), num_heads=HEADS,
                               dropout=rate, starts=torch.from_numpy(starts))
    assert not calls
