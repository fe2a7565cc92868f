"""HSTU's layer norms and attention: CUDA kernels beside their plain
PyTorch versions.

* :func:`hstu_norm` -- ``LN(h)`` over the last axis, the pre-norm of each
  HSTU block;
* :func:`hstu_gated_norm` -- ``U * LN(o)``, the gated norm of each block,
  reading the attention's output ``o [B, H, T, hd]`` as ``A V`` leaves it
  and ``U`` as the strided view its split gives;
* :func:`hstu_attention` -- each block's attention, ``SiLU(Q K^T + rab) / T``
  masked causally and times ``V``, over each sequence's valid positions.

The norms run ``csrc/hstu_norm.cu`` (H1), the attention
``csrc/hstu_attention.cu`` (H2); neither replaces a TPU kernel: the JAX
package has no HSTU. The norms are bound by bytes (a few FLOPs an element),
and PyTorch's layer norm takes a non-vectorised path, a block a row, for
widths that are not a multiple of 4, such as HSTU-large's 50. H1 streams
tiles of consecutive rows through shared memory, so that loads and stores
move whole 16-byte words although a row of 50 floats starts on a 16-byte
boundary only every other row; eight lanes reduce each row. H2 forms each
tile of scores in registers and never writes a ``[B, H, T, T]`` tensor; it
visits only the key tiles a sequence's causal, valid pairs need.

Layer norms without affine: the biased variance, ``rsqrt(var + 1e-6)``, in
fp32, as :func:`torch.nn.functional.layer_norm`. For CUDA tensors the
wrappers launch the kernel and raise on input it does not take; for CPU
tensors, and only for those, they run the plain versions
(:func:`hstu_norm_plain`, :func:`hstu_gated_norm_plain`,
:func:`hstu_attention_plain`). Each wrapper's ``launches`` counts its
kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .topk_kernels import _route

EPS = 1e-6  # the public code's layer-norm eps
MAX_DIM = 256  # the widest row the kernels take (csrc/hstu_norm.cu, csrc/hstu_attention.cu kMaxD)


def hstu_norm_plain(h: torch.Tensor) -> torch.Tensor:
    """``LN(h)`` over the last axis, without affine."""
    return torch.nn.functional.layer_norm(h, h.shape[-1:], eps=EPS)


def hstu_gated_norm_plain(u: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``U * LN(concat_h o)``, ``[B, T, D]``, from ``u [B T, D]`` and ``o
    [B, H, T, D / H]``."""
    b, _, t, _ = o.shape
    d = u.shape[1]
    return u.reshape(b, t, d) * hstu_norm_plain(o.transpose(1, 2).reshape(b, t, d))


def _check_width(d: int, name: str) -> None:
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: rows of {d} floats; the kernel takes 1 to {MAX_DIM}")


def _check_f32(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.float32")


def hstu_norm(h: torch.Tensor) -> torch.Tensor:
    """:func:`hstu_norm_plain` of a contiguous f32 ``h [..., D]``, ``D <=
    256``; as ``csrc/hstu_norm.cu`` for CUDA tensors. Returns a contiguous
    tensor of ``h``'s shape."""
    _check_f32(h, "hstu_norm: h")
    if h.ndim < 1 or not h.is_contiguous():
        raise ValueError(f"hstu_norm: h must be a contiguous [..., D] tensor, got {list(h.shape)}")
    d = h.shape[-1]
    _check_width(d, "hstu_norm")
    if not _route(h, "hstu_norm"):
        return hstu_norm_plain(h)
    out = torch.empty_like(h)
    fn = _build.library().sbr_hstu_norm_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        status = fn(h.data_ptr(), out.data_ptr(), h.numel() // d, d, EPS, stream)
    _build.check(status, "hstu_norm")
    hstu_norm.launches += 1
    return out


def hstu_gated_norm(u: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """:func:`hstu_gated_norm_plain`: ``u [B T, D]`` f32 with unit column
    stride (any row stride: ``U`` of the split of ``[B T, 4 D]``), ``o [B,
    H, T, D / H]`` f32 and contiguous, ``D <= 256``; as ``csrc/hstu_norm.cu``
    for CUDA tensors. Returns ``[B, T, D]``, contiguous on the card."""
    _check_f32(u, "hstu_gated_norm: u")
    _check_f32(o, "hstu_gated_norm: o")
    if o.ndim != 4 or not o.is_contiguous():
        raise ValueError(f"hstu_gated_norm: o must be a contiguous [B, H, T, hd] tensor, got {list(o.shape)}")
    b, heads, t, hd = o.shape
    if u.ndim != 2 or u.shape[0] != b * t:
        raise ValueError(f"hstu_gated_norm: u must be [B T, D] = [{b * t}, D], got {list(u.shape)}")
    d = u.shape[1]
    _check_width(d, "hstu_gated_norm")
    if d % heads or d // heads != hd:
        raise ValueError(f"hstu_gated_norm: u's {d} columns are not o's {heads} heads of {hd}")
    if u.stride(1) != 1 or (u.shape[0] > 1 and u.stride(0) < d):
        raise ValueError(f"hstu_gated_norm: u's strides {u.stride()} are not rows of unit stride")
    if u.device != o.device:
        raise ValueError(f"hstu_gated_norm: u is on {u.device}, o on {o.device}")
    if not _route(o, "hstu_gated_norm"):
        return hstu_gated_norm_plain(u, o)
    out = torch.empty((b, t, d), dtype=torch.float32, device=o.device)
    fn = _build.library().sbr_hstu_gated_norm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        status = fn(u.data_ptr(), u.stride(0), o.data_ptr(), out.data_ptr(), b, heads, t, hd, EPS, stream)
    _build.check(status, "hstu_gated_norm")
    hstu_gated_norm.launches += 1
    return out


def hstu_position_index(t: int, max_len: int, device: torch.device) -> torch.Tensor:
    """``[t, t]`` int64 index into a block's ``pos_w`` of query ``i`` and
    key ``j``: ``max_len - 1 + j - i``."""
    idx = torch.arange(t, device=device)
    return max_len - 1 + idx[None, :] - idx[:, None]


def hstu_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    buckets: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``o [B, H, T, hd]``: per head ``A = SiLU(Q K^T + rab) / T`` times the
    causal mask (diagonal kept), then ``A V``, with ``rab[b, i, j] =
    ts_w[buckets[b, i, j]] + pos_w[N - 1 + j - i]`` (``pos_w [2 N - 1]``).
    Every position is computed: ``lengths`` is not read."""
    del lengths
    b_, _, t_, _ = q.shape
    max_len = (pos_w.shape[0] + 1) // 2
    rel = hstu_position_index(t_, max_len, q.device)
    causal = (rel <= max_len - 1).to(torch.float32)  # j <= i, the diagonal kept
    rab = ts_w.index_select(0, buckets.reshape(-1)).view(b_, t_, t_)
    rab += pos_w[rel]
    a = (q @ k.transpose(-1, -2)).add_(rab[:, None])  # [B, H, T, T]
    del rab
    a = torch.nn.functional.silu(a, inplace=True).div_(t_).mul_(causal)
    return a @ v


def hstu_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_w: torch.Tensor,
    ts_w: torch.Tensor,
    buckets: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`hstu_attention_plain` over each sequence's first ``lengths[b]``
    positions; as ``csrc/hstu_attention.cu`` for CUDA tensors, where rows
    at or past a length come out as zeros (``None``: every position valid).

    ``q``, ``k``, ``v``: f32 ``[B, H, T, hd]``, ``hd <= 256``, the views of
    the split of ``[B T, 4 D]`` (unit column stride, heads adjacent in a
    row), with one shape and one set of strides; ``pos_w`` f32 ``[2 N - 1]``
    with ``N >= T`` and ``ts_w`` f32 ``[n]``, both contiguous; ``buckets``
    int32 ``[B, T, T]`` contiguous, each in ``[0, n)``; ``lengths`` int64
    ``[B]``, each in ``[0, T]``. Values are checked for CPU tensors only
    (``lengths`` here, ``buckets`` by the plain gather): on the card a check
    would wait for the device, so the kernel clamps both into range instead.
    Returns a contiguous ``[B, H, T, hd]``."""
    for name, x in (("q", q), ("k", k), ("v", v), ("pos_w", pos_w), ("ts_w", ts_w)):
        _check_f32(x, f"hstu_attention: {name}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"hstu_attention: q, k, v must be one [B, H, T, hd] shape, got "
                         f"{list(q.shape)}, {list(k.shape)}, {list(v.shape)}")
    b, heads, t, hd = q.shape
    _check_width(hd, "hstu_attention")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError(f"hstu_attention: q, k, v have strides {q.stride()}, {k.stride()}, {v.stride()}")
    if q.stride(3) != 1 or (heads > 1 and q.stride(1) != hd):
        raise ValueError(f"hstu_attention: strides {q.stride()} are not rows of {heads} adjacent heads of {hd} "
                         "with unit column stride")
    if pos_w.ndim != 1 or not pos_w.is_contiguous() or pos_w.shape[0] % 2 == 0 or pos_w.shape[0] < 2 * t - 1:
        raise ValueError(f"hstu_attention: pos_w must be a contiguous [2 N - 1] with N >= {t}, got {list(pos_w.shape)}")
    if ts_w.ndim != 1 or not ts_w.is_contiguous() or ts_w.shape[0] < 1:
        raise ValueError(f"hstu_attention: ts_w must be a contiguous, non-empty [n], got {list(ts_w.shape)}")
    if buckets.dtype != torch.int32 or tuple(buckets.shape) != (b, t, t) or not buckets.is_contiguous():
        raise ValueError(f"hstu_attention: buckets must be a contiguous int32 [{b}, {t}, {t}], got "
                         f"{buckets.dtype} {list(buckets.shape)}")
    if lengths is not None and (lengths.dtype != torch.int64 or tuple(lengths.shape) != (b,)
                                or not lengths.is_contiguous()):
        raise ValueError(f"hstu_attention: lengths must be a contiguous int64 [{b}], got "
                         f"{lengths.dtype} {list(lengths.shape)}")
    others = (k, v, pos_w, ts_w, buckets) + (() if lengths is None else (lengths,))
    if any(x.device != q.device for x in others):
        raise ValueError(f"hstu_attention: inputs on {sorted({str(x.device) for x in (q,) + others})}, "
                         "expected one device")
    if not _route(q, "hstu_attention"):
        if lengths is not None and b and (int(lengths.min()) < 0 or int(lengths.max()) > t):
            raise ValueError(f"hstu_attention: lengths outside [0, {t}]")
        return hstu_attention_plain(q, k, v, pos_w, ts_w, buckets, lengths)
    out = torch.empty((b, heads, t, hd), dtype=torch.float32, device=q.device)
    fn = _build.library().sbr_hstu_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(2),
            pos_w.data_ptr(), (pos_w.shape[0] + 1) // 2, ts_w.data_ptr(), ts_w.shape[0], buckets.data_ptr(),
            None if lengths is None else lengths.data_ptr(), out.data_ptr(), b, heads, t, hd, stream,
        )
    _build.check(status, "hstu_attention")
    hstu_attention.launches += 1
    return out


hstu_norm.launches = 0
hstu_gated_norm.launches = 0
hstu_attention.launches = 0
