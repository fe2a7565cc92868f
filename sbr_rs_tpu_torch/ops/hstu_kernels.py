"""HSTU's layer norms: a CUDA kernel for narrow rows, beside its plain
PyTorch versions.

* :func:`hstu_norm` -- ``LN(h)`` over the last axis, the pre-norm of each
  HSTU block;
* :func:`hstu_gated_norm` -- ``U * LN(o)``, the gated norm of each block,
  reading the attention's output ``o [B, H, T, hd]`` as ``A V`` leaves it
  and ``U`` as the strided view its split gives.

Both run ``csrc/hstu_norm.cu``, which replaces no TPU kernel: the JAX
package has no HSTU. The norms are bound by bytes (a few FLOPs an element),
and PyTorch's layer norm takes a non-vectorised path, a block a row, for
widths that are not a multiple of 4, such as HSTU-large's 50. The kernel
streams tiles of consecutive rows through shared memory, so that loads and
stores move whole 16-byte words although a row of 50 floats starts on a
16-byte boundary only every other row; eight lanes reduce each row.

Layer norms without affine: the biased variance, ``rsqrt(var + 1e-6)``, in
fp32, as :func:`torch.nn.functional.layer_norm`. For CUDA tensors the
wrappers launch the kernel and raise on input it does not take; for CPU
tensors, and only for those, they run the plain versions
(:func:`hstu_norm_plain`, :func:`hstu_gated_norm_plain`). Each wrapper's
``launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .topk_kernels import _route

EPS = 1e-6  # the public code's layer-norm eps
MAX_DIM = 256  # the widest row the kernel takes (csrc/hstu_norm.cu kMaxD)


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


hstu_norm.launches = 0
hstu_gated_norm.launches = 0
