"""HSTU's attention (``ops/hstu_kernels.py hstu_attention``, H2): the plain
version against the chain ``hstu_apply`` computed inline before the
kernel, bit for bit; ``hstu_apply`` on the CPU with and without lengths
against the tower as it was, bit for bit; the inputs the wrapper refuses;
and, on a card only (skipped here), ``csrc/hstu_attention.cu`` against the
plain version.

This file imports no JAX, so that on a card it runs alone:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hstu_attention.py -m card``.

Card tolerance: the largest difference at a valid position over the
largest magnitude of the plain output, at most 1e-6. Both sum the same f32
products in other orders (FFMA in the kernel, cuBLAS's GEMMs in the
plain chain), ~2e-7 seen at the HSTU cell's shapes.
"""

import numpy as np
import pytest
import torch

from sbr_rs_tpu_torch.models import hstu
from sbr_rs_tpu_torch.models.towers import hstu_apply, hstu_time_buckets
from sbr_rs_tpu_torch.ops import hstu_kernels as hk

RTOL_CARD = 1e-6


def _todays_chain(q, k, v, pos_w, ts_w, buckets):
    """The attention as ``hstu_apply`` computed it inline before H2."""
    b_, _, t_, _ = q.shape
    max_len = (pos_w.shape[0] + 1) // 2
    idx = torch.arange(t_, device=q.device)
    rel = max_len - 1 + idx[None, :] - idx[:, None]
    causal = (rel <= max_len - 1).to(torch.float32)
    rab = ts_w.index_select(0, buckets.view(-1)).view(b_, t_, t_)
    rab += pos_w[rel]
    a = (q @ k.transpose(-1, -2)).add_(rab[:, None])
    del rab
    a = torch.nn.functional.silu(a, inplace=True).div_(t_).mul_(causal)
    return a @ v


def _parents_tower(params, x, times, num_heads):
    """``hstu_apply`` as it was before H2: the inline chain, the norms
    through ``ops/hstu_kernels.py`` (their CPU routes are unchanged)."""
    b_, t_, d = x.shape
    pos = params["pos"]
    max_len = pos.shape[0]
    hd = d // num_heads
    buckets = hstu_time_buckets(times)
    h = x.to(torch.float32) * d**0.5 + pos[:t_]
    for layer in params["layers"]:
        uvqk = torch.nn.functional.silu(hk.hstu_norm(h).reshape(b_ * t_, d) @ layer["w_uvqk"])
        u, v, q, k = uvqk.split(d, dim=1)
        v, q, k = (z.reshape(b_, t_, num_heads, hd).transpose(1, 2) for z in (v, q, k))
        o = _todays_chain(q, k, v, layer["pos_w"], layer["ts_w"], buckets)
        y = hk.hstu_gated_norm(u, o)
        h = h + (y.reshape(b_ * t_, d) @ layer["w_o"] + layer["b_o"]).reshape(b_, t_, d)
    return h / h.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def _inputs(b, heads, t, hd, device="cpu", seed=0, max_len=None, offset=0, scale=1.0):
    """``q, k, v`` as the split of ``[B T, 4 D]`` leaves them (``offset``
    floats into their storage), a block's biases (``pos_w`` of ``2 N - 1``
    entries, ``ts_w`` of 129) and ``[B, T, T]`` int32 buckets."""
    max_len = max_len or t
    d = heads * hd
    g = torch.Generator().manual_seed(seed)
    flat = (torch.randn((offset + b * t * 4 * d,), generator=g) * scale).to(device)
    _, v, q, k = flat[offset:].view(b * t, 4 * d).split(d, dim=1)
    v, q, k = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (v, q, k))
    pos_w = (0.5 * torch.randn((2 * max_len - 1,), generator=g)).to(device)
    ts_w = (0.5 * torch.randn((129,), generator=g)).to(device)
    buckets = torch.randint(0, 129, (b, t, t), generator=g, dtype=torch.int32).to(device)
    return q, k, v, pos_w, ts_w, buckets


def _tower(device, layers=8, heads=2, d=50, t=12, b=3, seed=5):
    model = hstu.Hyperparameters(100, t).embedding_dim(d).num_layers(layers).num_heads(heads)
    params = model.from_seed(seed).build("cpu")._params["tower"]
    params = {"pos": params["pos"].to(device),
              "layers": [{k: v.to(device) for k, v in layer.items()} for layer in params["layers"]]}
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((b, t, d), generator=g).to(device)
    times = torch.cumsum(torch.randint(1, 10**6, (b, t + 1), generator=g), dim=1).to(device)
    return params, x, times, heads


@pytest.fixture
def zero_counters():
    hk.hstu_attention.launches = 0
    yield
    hk.hstu_attention.launches = 0


@pytest.mark.parametrize("hd", [25, 64])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("t", [1, 7, 64, 65, 200])
def test_plain_is_the_inline_chain(t, heads, hd):
    args = _inputs(2, heads, t, hd, seed=t + heads + hd)
    assert torch.equal(hk.hstu_attention_plain(*args), _todays_chain(*args))


@pytest.mark.parametrize("max_len", [None, 20])
def test_cpu_wrapper_is_the_plain_version_and_ignores_lengths(max_len, zero_counters):
    args = _inputs(3, 2, 9, 25, seed=1, max_len=max_len)
    want = _todays_chain(*args)
    for lengths in (None, torch.tensor([9, 1, 4])):
        assert torch.equal(hk.hstu_attention(*args, lengths), want)
    assert hk.hstu_attention.launches == 0


@pytest.mark.parametrize("lengths", ["none", "full"])
@pytest.mark.parametrize("shape", [(3, 12, 50, 2), (2, 7, 8, 1), (4, 33, 16, 4)])
def test_cpu_tower_is_the_parents(shape, lengths, zero_counters):
    b, t, d, heads = shape
    params, x, times, _ = _tower("cpu", layers=3, heads=heads, d=d, t=t, b=b)
    given = None if lengths == "none" else torch.full((b,), t, dtype=torch.int64)
    got = hstu_apply(params, x, times, heads, given)
    assert torch.equal(got, _parents_tower(params, x, times, heads))
    assert hk.hstu_attention.launches == 0


def test_cpu_tower_output_does_not_depend_on_lengths(zero_counters):
    """On the CPU ``lengths`` is checked and not read: shorter lengths give
    the full window's output, bit for bit."""
    params, x, times, heads = _tower("cpu", layers=2)
    full = hstu_apply(params, x, times, heads)
    assert torch.equal(hstu_apply(params, x, times, heads, torch.tensor([1, 5, 12])), full)


def _cpu_args(**over):
    q, k, v, pos_w, ts_w, buckets = _inputs(2, 2, 5, 25, seed=3)
    args = {"q": q, "k": k, "v": v, "pos_w": pos_w, "ts_w": ts_w, "buckets": buckets, "lengths": torch.tensor([5, 2])}
    args.update(over)
    return args


def _contiguous_heads():
    q = torch.randn((2, 2, 5, 25))  # heads not adjacent in a row: stride(1) = T hd
    return {"q": q, "k": q.clone(), "v": q.clone()}


REFUSED = {
    "q_f64": lambda: _cpu_args(q=_cpu_args()["q"].double()),
    "v_f64": lambda: _cpu_args(v=_cpu_args()["v"].double()),
    "pos_w_f64": lambda: _cpu_args(pos_w=_cpu_args()["pos_w"].double()),
    "ts_w_f16": lambda: _cpu_args(ts_w=_cpu_args()["ts_w"].half()),
    "q_3d": lambda: _cpu_args(q=_cpu_args()["q"][0]),
    "k_shape": lambda: _cpu_args(k=_cpu_args()["k"][:, :, :4]),
    "width_257": lambda: _cpu_args(**{n: torch.randn((1, 1, 2, 257)) for n in "qkv"}, buckets=torch.zeros(
        (1, 2, 2), dtype=torch.int32), lengths=None),
    "heads_not_adjacent": lambda: _cpu_args(**_contiguous_heads()),
    "column_stride": lambda: _cpu_args(**{n: torch.randn((2, 2, 5, 50))[..., ::2] for n in "qkv"}),
    "k_strides": lambda: _cpu_args(k=_cpu_args()["k"].contiguous()),
    "pos_w_short": lambda: _cpu_args(pos_w=torch.randn((7,))),
    "pos_w_even": lambda: _cpu_args(pos_w=torch.randn((10,))),
    "pos_w_2d": lambda: _cpu_args(pos_w=torch.randn((9, 1))),
    "ts_w_empty": lambda: _cpu_args(ts_w=torch.randn((0,))),
    "buckets_int64": lambda: _cpu_args(buckets=_cpu_args()["buckets"].long()),
    "buckets_shape": lambda: _cpu_args(buckets=_cpu_args()["buckets"][:, :4]),
    "buckets_strided": lambda: _cpu_args(buckets=_cpu_args()["buckets"].transpose(1, 2)),
    "lengths_int32": lambda: _cpu_args(lengths=torch.tensor([5, 2], dtype=torch.int32)),
    "lengths_shape": lambda: _cpu_args(lengths=torch.tensor([5, 2, 1])),
    "lengths_negative": lambda: _cpu_args(lengths=torch.tensor([5, -1])),
    "lengths_past_t": lambda: _cpu_args(lengths=torch.tensor([6, 2])),
    "device_mismatch": lambda: _cpu_args(ts_w=torch.empty((129,), device="meta")),
    "meta": lambda: {n: (x.to("meta") if x is not None else None) for n, x in _cpu_args().items()},
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_before_any_launch(case, zero_counters):
    args = REFUSED[case]()
    with pytest.raises(ValueError):
        hk.hstu_attention(**args)
    assert hk.hstu_attention.launches == 0


def test_tower_refuses_lengths_out_of_range(zero_counters):
    params, x, times, heads = _tower("cpu", layers=1)
    with pytest.raises(ValueError, match="lengths"):
        hstu_apply(params, x, times, heads, torch.tensor([1, 13, 2]))


def test_the_cpu_model_launches_nothing(zero_counters):
    model = hstu.Hyperparameters(100, 8).embedding_dim(16).num_layers(2).num_heads(2).from_seed(3).build("cpu")
    ids = model.recommend_batch([[1, 2, 3], [4, 5], []], k=5, timestamps=[[10, 20, 30], [10, 50], []])
    assert [len(row) for row in ids] == [5, 5, 5]
    assert hk.hstu_attention.launches == 0


# -- on a card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _check_card(args, lengths, card):
    """H2 against the plain version at every valid position, zeros past each
    length; returns the relative difference."""
    b, _, t, _ = args[0].shape
    given = None if lengths is None else torch.tensor(lengths, dtype=torch.int64, device=card)
    got = hk.hstu_attention(*args, given)
    want = hk.hstu_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    lens = torch.tensor([t] * b if lengths is None else lengths, device=card)
    valid = (torch.arange(t, device=card)[None, :] < lens[:, None])[:, None, :, None].expand_as(got)
    assert bool((got[~valid] == 0).all())
    assert bool(torch.isfinite(got).all())
    rel = float((got - want).abs()[valid].max() / want.abs().max()) if bool(valid.any()) else 0.0
    assert rel <= RTOL_CARD, rel
    return rel


@pytest.mark.card
@pytest.mark.parametrize("hd, heads", [(1, 3), (4, 5), (7, 1), (8, 8), (16, 4), (25, 2), (25, 1), (32, 3),
                                       (40, 2), (64, 2), (100, 1), (128, 2), (200, 1), (256, 1)])
@pytest.mark.parametrize("t, lengths, offset", [
    (1, [1, 0, 1], 0), (7, None, 1), (33, [1, 32, 33], 3), (65, [65, 64, 2], 0), (200, [200, 199, 1, 68, 31], 2),
])
def test_card_kernel_matches_the_plain_version(card, hd, heads, t, lengths, offset, zero_counters):
    """Lengths 1, T - 1 and T and a mix, views that start off a 16-byte
    boundary (``offset``), head widths 1 to 256."""
    b = 3 if lengths is None else len(lengths)
    args = _inputs(b, heads, t, hd, card, seed=hd + t, offset=offset, max_len=t + 5)
    _check_card(args, lengths, card)
    assert hk.hstu_attention.launches == 1


@pytest.mark.card
@pytest.mark.parametrize("scale", [1e-3, 6.0])
def test_card_kernel_at_small_and_large_scores(card, scale, zero_counters):
    """Scores near 0 and far past 64 in magnitude (the divisions' other
    route) against the plain version."""
    args = _inputs(16, 2, 200, 25, card, seed=7, scale=scale)
    _check_card(args, [200, 199, 1, 2, 31, 32, 33, 64, 65, 100, 150, 180, 20, 40, 60, 80], card)


@pytest.mark.card
def test_card_kernel_at_the_cells_shapes(card, zero_counters):
    """8,192 histories of 200 positions, 2 heads of 25, lengths by the HSTU
    cell's law (log-normal, median 68, sigma 1.22, clipped to 20-200)."""
    rng = np.random.default_rng(24)
    lengths = np.clip(np.rint(rng.lognormal(np.log(68), 1.22, 8192)), 20, 200).astype(np.int64).tolist()
    args = _inputs(8192, 2, 200, 25, card, seed=24)
    _check_card(args, lengths, card)
    _check_card(args, None, card)


@pytest.mark.card
def test_card_tower_launches_one_kernel_a_block(card, zero_counters):
    """An 8-block tower launches H2 8 times, with or without lengths, and at
    full lengths gives the tower with the plain attention on the card
    within 2e-6 (unit vectors, as ``tests/test_torch_hstu.py``)."""
    args = _tower(card)
    out = hstu_apply(*args)
    torch.cuda.synchronize()
    assert hk.hstu_attention.launches == 8
    b = args[1].shape[0]
    full = hstu_apply(*args, torch.full((b,), args[1].shape[1], dtype=torch.int64, device=card))
    assert hk.hstu_attention.launches == 16
    assert torch.equal(out, full)
    plain = _parents_tower(*args)
    assert float((out - plain).abs().max()) <= 2e-6


@pytest.mark.card
def test_card_tower_allocates_no_score_tensor(card, zero_counters):
    """The tower's peak memory stays below one ``[U, H, T, T]`` f32 tensor."""
    b, t, heads = 64, 200, 8
    args = _tower(card, layers=2, heads=heads, d=64, t=t, b=b)
    hstu_apply(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    hstu_apply(*args, torch.full((b,), t, dtype=torch.int64, device=card))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - base < 4 * b * heads * t * t


@pytest.mark.card
def test_card_serving_matches_the_cpu_route(card, zero_counters):
    """``recommend_batch`` on the card (H2 over each window's length) and on
    the CPU (every position, the plain chain): the same lists, scores within
    ``tests/test_torch_hstu.py``'s 1e-5."""
    model = hstu.Hyperparameters(300, 24).embedding_dim(50).num_layers(8).num_heads(2).from_seed(9)
    on_cpu, on_card = model.build("cpu"), model.build(card)
    on_cpu._params["item_table"][:, -1] = torch.randn(300, generator=torch.Generator().manual_seed(9))  # no near ties
    on_card.load_params(on_cpu._params)
    rng = np.random.default_rng(9)
    lens = [0, 1, 2, 23, 24, 25, 60, 7, 13]
    hist = [rng.integers(0, 300, n).tolist() for n in lens]
    times = [np.cumsum(rng.integers(1, 10**6, n)).tolist() for n in lens]
    want = on_cpu.recommend_batch(hist, k=10, return_scores=True, timestamps=times)
    got = on_card.recommend_batch(hist, k=10, return_scores=True, timestamps=times)
    assert hk.hstu_attention.launches == 8
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
