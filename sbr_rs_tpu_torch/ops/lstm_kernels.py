"""The LSTM recurrence, forward: a CUDA kernel and its plain PyTorch version.

Counterpart of the forward half of :mod:`sbr_rs_tpu.ops.pallas_lstm`. The
kernel (``csrc/lstm_fwd.cu``) replaces the Pallas ``_fwd_kernel``; the input
projection ``x @ w_x + b`` stays outside it as one ``torch.matmul`` over all
timesteps, as the TPU version kept it outside.

:func:`lstm_fwd` launches the kernel for CUDA tensors and raises on input
it does not take; for CPU tensors, and only for those, it runs
:func:`lstm_fwd_plain`. There is no switch that turns the kernel off.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

Params = Dict[str, torch.Tensor]


def lstm_fwd_plain(
    xz: torch.Tensor, w_h: torch.Tensor, keep: torch.Tensor, coupled: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time loop over ``xz [T, B, G*D]`` with ``keep [T, B, 1]`` (0 where a
    window starts: the carries reset there). Returns ``(hidden, cell)``,
    both ``[T, B, D]`` f32. Gate order ``[i, f, g, o]``, or ``[i, g, o]``
    with ``f = 1 - i`` when ``coupled``."""
    t_len, b, _ = xz.shape
    d = w_h.shape[0]
    h = xz.new_zeros((b, d), dtype=torch.float32)
    c = xz.new_zeros((b, d), dtype=torch.float32)
    hidden = xz.new_empty((t_len, b, d), dtype=torch.float32)
    cell = xz.new_empty((t_len, b, d), dtype=torch.float32)
    for t in range(t_len):
        h = h * keep[t]
        c = c * keep[t]
        z = xz[t] + h @ w_h
        if coupled:
            i, g, o = z.split(d, dim=-1)
            i = torch.sigmoid(i)
            c = (1.0 - i) * c + i * torch.tanh(g)
        else:
            i, f, g, o = z.split(d, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hidden[t] = h
        cell[t] = c
    return hidden, cell


def _require(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lstm_fwd(
    xz: torch.Tensor, w_h: torch.Tensor, keep: torch.Tensor, coupled: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`lstm_fwd_plain`, as the CUDA kernel for CUDA
    tensors. ``lstm_fwd.launches`` counts the kernel's launches."""
    if xz.device.type == "cpu":
        return lstm_fwd_plain(xz, w_h, keep, coupled)
    if xz.device.type != "cuda":
        raise ValueError(f"lstm_fwd runs on cuda or cpu, not {xz.device}")
    t_len, b, gd = xz.shape
    d = w_h.shape[0]
    gates = 3 if coupled else 4
    if gd != gates * d:
        raise ValueError(f"xz has {gd} gate columns, expected {gates} x {d}")
    if d > 1024:
        raise ValueError(f"lstm_fwd takes D <= 1024 (one thread per unit), got {d}")
    _require(xz, "xz", (t_len, b, gd), torch.float32, xz.device)
    _require(w_h, "w_h", (d, gd), torch.float32, xz.device)
    _require(keep, "keep", (t_len, b, 1), torch.float32, xz.device)
    hidden = torch.empty((t_len, b, d), dtype=torch.float32, device=xz.device)
    cell = torch.empty_like(hidden)
    fn = _build.library().sbr_lstm_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xz.device):
        stream = torch.cuda.current_stream(xz.device).cuda_stream
        status = fn(
            xz.data_ptr(), w_h.data_ptr(), keep.data_ptr(), hidden.data_ptr(),
            cell.data_ptr(), t_len, b, d, int(coupled), stream,
        )
    _build.check(status, "lstm_fwd")
    lstm_fwd.launches += 1
    return hidden, cell


lstm_fwd.launches = 0


def time_major_inputs(
    params: Params, x: torch.Tensor, starts: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``xz = x @ w_x + b`` for ``x [B, T, D]`` as one matmul over all
    timesteps, laid out time-major ``[T, B, G*D]`` and contiguous, and
    ``keep = 1 - starts`` as ``[T, B, 1]`` (all ones without ``starts``)."""
    b, t_len, d = x.shape
    xz = (x.reshape(b * t_len, d) @ params["w_x"]).reshape(b, t_len, -1) + params["b"]
    xz = xz.transpose(0, 1).contiguous()
    if starts is None:
        keep = xz.new_ones((t_len, b, 1))
    else:
        keep = (1.0 - starts.to(torch.float32)).transpose(0, 1)[..., None].contiguous()
    return xz, keep


def lstm_apply_kernel(
    params: Params,
    x: torch.Tensor,
    coupled: bool,
    starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Counterpart of ``lstm_apply_pallas``: hidden states ``[B, T, D]`` for
    ``x [B, T, D]``, with the recurrence in :func:`lstm_fwd` (the kernel on
    CUDA). ``starts [B, T]`` marks packed-window starts."""
    xz, keep = time_major_inputs(params, x, starts)
    hidden, _ = lstm_fwd(xz, params["w_h"], keep, coupled)
    return hidden.transpose(0, 1)
