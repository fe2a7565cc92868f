"""The precision argument of the port's 3xTF32 kernels, on the CPU.

``csrc/tf32x3.cuh`` splits each f32 operand into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` with ``cvt.rna.tf32.f32`` and replaces each product by
``a_lo b_hi + a_hi b_lo + a_hi b_hi``; it states that the dropped part of a
dot product is at most ``3 * 2^-22 * (1 + 2^-10) * sum |a||b|`` for f32 rows
and ``2^-22 * (1 + 2^-10) * sum |a||b|`` for bf16 rows (exact in TF32, so
``lo = 0``). The CUDA kernels cannot run here, so this file emulates the
rounding in numpy (to nearest, ties away from zero, 10 mantissa bits), sums
the three products in float64 and holds the result to that bound against
the float64 dot, at the shapes of K5 (``score_count_ge``) and of K2's dW_h
reduction. It also checks the dW_h launch geometry, which is pure Python.
"""

import ml_dtypes
import numpy as np
import pytest

from sbr_rs_tpu_torch.ops import lstm_kernels

BOUND_F32 = 3 * 2.0**-22 * (1 + 2.0**-10)
BOUND_EXACT_A = 2.0**-22 * (1 + 2.0**-10)


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: round an f32 array to 10 mantissa bits, to
    nearest with ties away from zero (adding half an ulp to the magnitude
    bits, then truncating); the low 13 bits of the result are zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)  # x - hi is exact in f32


def three_products(a, b):
    """``a [m, K] x b [n, K]^T`` as the kernels form it, summed in float64
    (products of TF32 values are exact there)."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return f(al) @ f(bh).T + f(ah) @ f(bl).T + f(ah) @ f(bh).T


def test_rounding_emulation():
    one = np.float32(1.0)
    ulp = 2.0**-10
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 2, 3.0, -0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), one, 1 + 2 * ulp, 3.0, -0.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)  # ties go away from zero
    y = np.random.default_rng(0).normal(size=10_000).astype(np.float32) * 10.0 ** np.arange(-5, 5).repeat(1000)
    r = tf32_rna(y)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(r.astype(np.float64) - y) <= 2.0**-11 * np.abs(y)).all()
    hi, lo = split(y)
    assert (np.abs(y.astype(np.float64) - hi - lo) <= 2.0**-22 * np.abs(y)).all()


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cc", [8, 33, 128, 512])
def test_score_split_within_bound(cc, rows_dtype):
    """K5's scores: rows [c, cc] (f32, or bf16 values) against reps [u, cc]
    f32, with magnitudes spread over six decades so that the split meets
    every exponent."""
    rng = np.random.default_rng(cc)
    rows = (rng.normal(size=(300, cc)) * 10.0 ** rng.uniform(-3, 3, (300, 1))).astype(np.float32)
    if rows_dtype == "bfloat16":
        rows = rows.astype(ml_dtypes.bfloat16).astype(np.float32)
    reps = (rng.normal(size=(40, cc)) * cc**-0.5).astype(np.float32)
    exact = rows.astype(np.float64) @ reps.astype(np.float64).T
    scale = np.abs(rows).astype(np.float64) @ np.abs(reps).astype(np.float64).T
    err = np.abs(three_products(rows, reps) - exact)
    bound = BOUND_EXACT_A if rows_dtype == "bfloat16" else BOUND_F32
    assert (err <= bound * scale).all(), float((err / scale).max())
    # The split does what it is for: plain TF32 (hi * hi) is far outside it.
    hi_only = tf32_rna(rows).astype(np.float64) @ tf32_rna(reps).astype(np.float64).T
    assert (np.abs(hi_only - exact) > 16 * BOUND_F32 * scale).any()
    if rows_dtype == "bfloat16":
        hi, lo = split(rows)
        assert np.array_equal(hi, rows) and not lo.any()


def test_bf16_values_split_with_zero_lo():
    bits = np.random.default_rng(1).integers(0, 2**16, 200_000, dtype=np.uint32).astype(np.uint16)
    x = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    x = x[np.isfinite(x)]
    hi, lo = split(x)
    assert np.array_equal(hi.view(np.uint32), x.view(np.uint32)) and not lo.any()


# K2's dW_h at the main paths' (T, B, D, gates), T * B scaled down: fit-ml1m
# (128, 256, 128, Coupled), fit-10M-sparse (64, 256, 127, Coupled),
# fit-bench (32, 256, 32, Normal) and chip_smoke's (32, 4096, 127, Normal).
DWH_SHAPES = [(8, 16, 128, 3), (6, 16, 127, 3), (8, 32, 32, 4), (4, 64, 127, 4)]


@pytest.mark.parametrize("t_len,b,d,gates", DWH_SHAPES)
def test_dwh_split_within_bound(t_len, b, d, gates):
    """dW_h = A^T dz over the (T-1) * B rows, A = hidden * keep applied
    before the split, as the kernel does."""
    rng = np.random.default_rng(d + gates)
    hidden = np.tanh(rng.normal(size=(t_len, b, d))).astype(np.float32)
    keep = (rng.random((t_len, b, 1)) > 0.1).astype(np.float32)
    dxz = (rng.normal(size=(t_len, b, gates * d)) * 10.0 ** rng.uniform(-2, 2, (t_len, b, 1))).astype(np.float32)
    a = (hidden[:-1] * keep[1:]).reshape(-1, d)
    z = dxz[1:].reshape(-1, gates * d)
    exact = a.T.astype(np.float64) @ z.astype(np.float64)
    scale = np.abs(a.T).astype(np.float64) @ np.abs(z).astype(np.float64)
    err = np.abs(three_products(a.T, z.T) - exact)
    assert (err <= BOUND_F32 * scale).all(), float((err / np.maximum(scale, 1e-300)).max())


@pytest.mark.parametrize("slots", [264, 132, 114, 7, 1])
@pytest.mark.parametrize(
    "m,d,gd",
    [(127 * 256, 128, 384), (63 * 256, 127, 381), (31 * 256, 32, 128), (31 * 4096, 127, 508), (0, 128, 384),
     (100, 9, 36), (129, 8, 24)],
)
def test_dwh_geometry_covers_rows_and_tiles(m, d, gd, slots):
    splits, chunk, tiles_k, tiles_c = lstm_kernels.dwh_geometry(m, d, gd, slots)
    assert splits >= 1 and chunk % 32 == 0 and chunk >= 32
    # Every row in exactly one split [s * chunk, min(m, (s + 1) * chunk)),
    # and no split empty.
    owner = np.arange(m) // chunk
    assert owner.max(initial=0) < splits
    assert np.array_equal(np.bincount(owner, minlength=splits) > 0, np.full(splits, m > 0))
    # The 64 x 128 tiles cover [d, gd], none wholly outside.
    assert (tiles_k - 1) * 64 < d <= tiles_k * 64 and (tiles_c - 1) * 128 < gd <= tiles_c * 128
    # One wave: no more blocks than slots, unless the tiles alone outnumber them.
    assert splits * tiles_k * tiles_c <= slots or splits == 1


# -- the accumulation: K4's phase-1 bound (ops/topk_kernels.py phase1_gamma) --


def _truncate_f32(x):
    """float64 -> float32 rounded toward zero, as the tensor cores round."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _align(x, ulp):
    """``x`` cut to a multiple of ``ulp`` toward zero: an operand shifted to
    the exponent of the largest one, its low bits dropped."""
    return np.sign(x) * np.floor(np.abs(x) / ulp) * ulp


def tensor_core_dot(a, b, model):
    """``a [m, K] x b [n, K]^T`` as K4 issues it: per 8-deep k-step the
    wgmmas a_lo b_hi, a_hi b_lo, a_hi b_hi (the first skipped when a is
    exact in TF32) into one FP32 accumulator. ``model`` is how the tensor
    cores might add: "sequential" (each product added and the sum truncated
    to FP32) or "aligned" (each wgmma's 8 products and the accumulator
    aligned to the largest of them, cut to 24 bits there, summed, and the
    sum truncated)."""
    (ah, al), (bh, bl) = split(a), split(b)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    exact_a = not al.any()
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        pairs = ([] if exact_a else [(al, bh)]) + [(ah, bl), (ah, bh)]
        for x, y in pairs:
            prods = f(x[:, ks])[:, None, :] * f(y[:, ks])[None, :, :]  # exact: TF32 x TF32
            if model == "sequential":
                for q in range(prods.shape[2]):
                    acc = _truncate_f32(f(acc) + prods[:, :, q])
            else:
                top = np.maximum(np.abs(f(acc)), np.abs(prods).max(axis=2))
                ulp = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
                total = _align(f(acc), ulp) + _align(prods, ulp[:, :, None]).sum(axis=2)
                acc = _truncate_f32(total)
    return acc


@pytest.mark.parametrize("model", ["sequential", "aligned"])
@pytest.mark.parametrize("signs", ["positive", "mixed"])
@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cc", [33, 128, 512])
def test_phase1_gamma_covers_truncating_accumulation(cc, rows_dtype, signs, model):
    """The 3xTF32 score's distance from the exact dot stays within the
    phase-1 part of phase1_gamma (split + accumulation) times sum |a||b|,
    under either model of the tensor cores' truncation; all-positive
    inputs let no cancellation hide the error."""
    import torch

    from sbr_rs_tpu_torch.ops import topk_kernels

    rng = np.random.default_rng(cc + (rows_dtype == "bfloat16"))
    if signs == "positive":
        rows = rng.uniform(0.5, 1.0, (48, cc)).astype(np.float32)
        reps = rng.uniform(0.5, 1.0, (24, cc)).astype(np.float32)
    else:
        rows = (rng.normal(size=(48, cc)) * 10.0 ** rng.uniform(-3, 3, (48, 1))).astype(np.float32)
        reps = (rng.normal(size=(24, cc)) * cc**-0.5).astype(np.float32)
    if rows_dtype == "bfloat16":
        rows = rows.astype(ml_dtypes.bfloat16).astype(np.float32)
    dtype = torch.bfloat16 if rows_dtype == "bfloat16" else torch.float32
    gamma = topk_kernels.phase1_gamma(cc, dtype, tensor_cores=True) - topk_kernels._gamma_fp32(cc)
    exact = rows.astype(np.float64) @ reps.astype(np.float64).T
    scale = np.abs(rows).astype(np.float64) @ np.abs(reps).astype(np.float64).T
    err = np.abs(tensor_core_dot(rows, reps, model) - exact)
    assert (err <= gamma * scale).all(), (float((err / scale).max()), gamma)
    # The truncation is what the accumulation term is for: on long positive
    # sums it costs far more than the split's own bound.
    if signs == "positive" and rows_dtype == "float32" and cc >= 128:
        assert float((err / scale).max()) > 4 * BOUND_F32
