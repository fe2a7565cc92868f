"""HSTU's layer norms (``ops/hstu_kernels.py``): the wrappers' CPU routes
against the expressions ``hstu_apply`` computed before the kernel, bit for
bit; the shapes, dtypes and strides the wrappers refuse; and, on a card
only (skipped here), ``csrc/hstu_norm.cu`` against the plain versions.

This file imports no JAX, so that on a card it runs alone:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hstu_norm.py -m card``.

Card tolerance: the largest difference over the largest magnitude of the
plain output, at most 1e-6. The kernel takes the mean and the variance in
two passes over the row, PyTorch's kernel by Welford's update, so the two
round differently by a few float32 ulps of the normalised values (~1e-7
relative) on rows whose mean is small beside their spread, as here.
"""

import pytest
import torch

from sbr_rs_tpu_torch.models import hstu, towers
from sbr_rs_tpu_torch.models.towers import hstu_apply
from sbr_rs_tpu_torch.ops import hstu_kernels as hk

EPS = 1e-6
RTOL_CARD = 1e-6


def _todays_norm(x):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], eps=EPS)


def _todays_gated(u, o):
    b, _, t, _ = o.shape
    d = u.shape[1]
    return u.reshape(b, t, d) * _todays_norm(o.transpose(1, 2).reshape(b, t, d))


def _inputs(b, heads, t, d, device="cpu", seed=0):
    """``u`` as the split of ``[B T, 4 D]`` leaves it (row stride 4 D) and a
    contiguous ``o [B, H, T, D / H]``."""
    g = torch.Generator().manual_seed(seed)
    uvqk = torch.randn((b * t, 4 * d), generator=g).to(device)
    o = torch.randn((b, heads, t, d // heads), generator=g).to(device)
    return uvqk.split(d, dim=1)[0], o


@pytest.fixture
def zero_counters():
    for fn in (hk.hstu_norm, hk.hstu_gated_norm):
        fn.launches = 0
    yield
    for fn in (hk.hstu_norm, hk.hstu_gated_norm):
        fn.launches = 0


@pytest.mark.parametrize("d", [8, 50, 64])
@pytest.mark.parametrize("shape", [(1,), (7,), (163,), (3, 27)])
def test_cpu_norm_is_the_layer_norm_expression(d, shape, zero_counters):
    h = torch.randn((*shape, d), generator=torch.Generator().manual_seed(d))
    got = hk.hstu_norm(h)
    assert got.shape == h.shape
    assert torch.equal(got, _todays_norm(h))
    assert hk.hstu_norm.launches == 0


@pytest.mark.parametrize("d", [8, 50, 64])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("b, t", [(1, 1), (3, 7), (2, 81)])
def test_cpu_gated_norm_is_the_gated_expression(d, heads, b, t, zero_counters):
    u, o = _inputs(b, heads, t, d, seed=d + heads)
    got = hk.hstu_gated_norm(u, o)
    assert got.shape == (b, t, d)
    assert torch.equal(got, _todays_gated(u, o))
    assert hk.hstu_gated_norm.launches == 0


def _wide(b, heads, t, hd):
    u = torch.randn((b * t, heads * hd))
    return u, torch.randn((b, heads, t, hd))


REFUSED = {
    "norm_f64": lambda: hk.hstu_norm(torch.randn((5, 50), dtype=torch.float64)),
    "norm_width_257": lambda: hk.hstu_norm(torch.randn((5, 257))),
    "norm_not_contiguous": lambda: hk.hstu_norm(torch.randn((50, 5)).T),
    "norm_meta": lambda: hk.hstu_norm(torch.empty((5, 50), device="meta")),
    "gated_u_f64": lambda: hk.hstu_gated_norm(*(lambda u, o: (u.double(), o))(*_inputs(2, 2, 3, 50))),
    "gated_o_f64": lambda: hk.hstu_gated_norm(*(lambda u, o: (u, o.double()))(*_inputs(2, 2, 3, 50))),
    "gated_width_300": lambda: hk.hstu_gated_norm(*_wide(2, 2, 3, 150)),
    "gated_width_not_heads": lambda: hk.hstu_gated_norm(torch.randn((6, 50)), torch.randn((2, 3, 3, 16))),
    "gated_width_not_o": lambda: hk.hstu_gated_norm(torch.randn((6, 48)), torch.randn((2, 2, 3, 25))),
    "gated_o_transposed": lambda: hk.hstu_gated_norm(torch.randn((6, 50)), torch.randn((2, 3, 2, 25)).transpose(1, 2)),
    "gated_o_3d": lambda: hk.hstu_gated_norm(torch.randn((6, 50)), torch.randn((6, 2, 25))),
    "gated_u_rows": lambda: hk.hstu_gated_norm(torch.randn((7, 50)), torch.randn((2, 2, 3, 25))),
    "gated_u_column_stride": lambda: hk.hstu_gated_norm(torch.randn((6, 100))[:, ::2], torch.randn((2, 2, 3, 25))),
    "gated_meta": lambda: hk.hstu_gated_norm(
        torch.empty((6, 50), device="meta"), torch.empty((2, 2, 3, 25), device="meta")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_before_any_launch(case, zero_counters):
    with pytest.raises(ValueError):
        REFUSED[case]()
    assert hk.hstu_norm.launches == 0 and hk.hstu_gated_norm.launches == 0


@pytest.mark.parametrize("width", [257, 512])
@pytest.mark.parametrize("entry", ["build", "constructor"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_model_wider_than_the_norms_is_refused(width, entry, device):
    """A model wider than the norms' rows is refused when it is made (by
    ``build`` or, as a checkpoint's load does, by the class), on either
    device and before CUDA is looked for, so here too."""
    hp = hstu.Hyperparameters(100, 8).embedding_dim(width).num_heads(1)
    with pytest.raises(ValueError, match=f"embedding_dim={width}.*at most {hk.MAX_DIM}"):
        hp.build(device) if entry == "build" else hstu.ImplicitHSTUModel(hp, device)


def test_a_model_of_the_widest_rows_serves_on_the_cpu(zero_counters):
    model = hstu.Hyperparameters(100, 8).embedding_dim(hk.MAX_DIM).num_heads(4).from_seed(3).build("cpu")
    ids = model.recommend_batch([[1, 2, 3], [4, 5]], k=5, timestamps=[[10, 20, 30], [10, 50]])
    assert [len(row) for row in ids] == [5, 5]
    assert hk.hstu_norm.launches == 0 and hk.hstu_gated_norm.launches == 0


def _tower(device, layers=8, heads=2, d=50, t=12, b=3):
    model = hstu.Hyperparameters(100, t).embedding_dim(d).num_layers(layers).num_heads(heads)
    params = model.from_seed(5).build("cpu")._params["tower"]
    params = {"pos": params["pos"].to(device),
              "layers": [{k: v.to(device) for k, v in layer.items()} for layer in params["layers"]]}
    g = torch.Generator().manual_seed(6)
    x = torch.randn((b, t, d), generator=g).to(device)
    times = torch.cumsum(torch.randint(1, 10**6, (b, t + 1), generator=g), dim=1).to(device)
    return params, x, times, heads


def test_the_cpu_tower_launches_nothing(zero_counters):
    out = hstu_apply(*_tower("cpu"))
    assert torch.isfinite(out).all()
    assert hk.hstu_norm.launches == 0 and hk.hstu_gated_norm.launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("d, heads", [(8, 1), (50, 1), (50, 2), (64, 2), (256, 4), (255, 5)])
@pytest.mark.parametrize("b, t, offset", [(1, 1, 0), (3, 7, 0), (5, 200, 0), (4, 81, 1)])
def test_card_kernels_match_the_plain_versions(card, d, heads, b, t, offset, zero_counters):
    """``offset`` starts ``h`` and ``o`` one float past a 16-byte boundary
    (the kernel's single-float route); T = 7 and 81 give slices of ``o``
    that are not a whole number of 16-byte words."""
    g = torch.Generator(device=card).manual_seed(d + t)
    flat = torch.randn((b * t * d + offset,), device=card, generator=g)
    h = flat[offset:].view(b, t, d)
    got = hk.hstu_norm(h)
    assert got.is_contiguous() and _rel(got, hk.hstu_norm_plain(h)) <= RTOL_CARD
    uvqk = torch.randn((b * t, 4 * d), device=card, generator=g)
    u = uvqk.split(d, dim=1)[0]
    o = flat[offset:].view(b, heads, t, d // heads)
    got = hk.hstu_gated_norm(u, o)
    assert got.shape == (b, t, d) and _rel(got, hk.hstu_gated_norm_plain(u, o)) <= RTOL_CARD
    torch.cuda.synchronize()
    assert hk.hstu_norm.launches == 1 and hk.hstu_gated_norm.launches == 1


@pytest.mark.card
def test_card_tower_launches_two_kernels_a_block(card, zero_counters, monkeypatch):
    """An 8-block tower launches each kernel 8 times, and its output is the
    same tower's with the plain norms on the card within 2e-6 (unit vectors,
    as ``tests/test_torch_hstu.py``)."""
    args = _tower(card)
    out = hstu_apply(*args)
    torch.cuda.synchronize()
    assert hk.hstu_norm.launches == 8 and hk.hstu_gated_norm.launches == 8
    monkeypatch.setattr(towers, "hstu_norm", hk.hstu_norm_plain)
    monkeypatch.setattr(towers, "hstu_gated_norm", hk.hstu_gated_norm_plain)
    assert float((out - hstu_apply(*args)).abs().max()) <= 2e-6
    assert hk.hstu_norm.launches == 8 and hk.hstu_gated_norm.launches == 8


@pytest.mark.card
def test_card_model_at_the_widest_row_serves(card, zero_counters):
    """A 2-block model of the kernel's widest rows builds and serves on the
    card, through the kernels."""
    model = hstu.Hyperparameters(100, 8).embedding_dim(hk.MAX_DIM).num_heads(4).num_layers(2)
    ids = model.from_seed(3).build(card).recommend_batch([[1, 2, 3], [4, 5]], k=5,
                                                          timestamps=[[10, 20, 30], [10, 50]])
    assert [len(row) for row in ids] == [5, 5]
    assert hk.hstu_norm.launches == 2 and hk.hstu_gated_norm.launches == 2
