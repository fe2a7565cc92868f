"""The LSTM recurrence, forward and backward: CUDA kernels, each beside its
plain PyTorch version. Counterpart of :mod:`sbr_rs_tpu.ops.pallas_lstm`.

* :func:`lstm_fwd` (``csrc/lstm_fwd.cu``) replaces the Pallas ``_fwd_kernel``;
* :func:`lstm_bwd` (``csrc/lstm_bwd.cu``) replaces ``_bwd_kernel``: the
  reverse-time adjoint writing ``dxz``, then :func:`lstm_bwd_dwh`, the
  ``dW_h`` reduction of the same source;
* :class:`LSTMFunction` joins the two as one differentiable op, as
  ``jax.custom_vjp`` does around ``lstm_apply_pallas``.

The input projection ``x @ w_x + b`` stays outside the kernels as one
``torch.matmul`` over all timesteps, and PyTorch's autograd of it gives
``dw_x``, ``db`` and ``dx``, as the TPU version left them to XLA.

Each wrapper launches its kernel for CUDA tensors and raises on input it
does not take; for CPU tensors, and only for those, it runs the plain
version. There is no switch that turns a kernel off.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

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


SMEM_OPTIN = 232_448  # shared memory one block of sm_90 may opt in to, bytes
_CLUSTERS = (1, 2, 4, 8)  # portable thread-block cluster sizes
_L2_FWD_ROWS = 8  # rows a block of the forward's L2 route
_MIN_THREADS = 128  # four warps: fewer leave a step's latency exposed


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def w_stride(gdc: int) -> int:
    """Row stride, in floats, of the resident ``w_h`` slice with ``gdc`` gate
    columns: the least value >= ``gdc`` that is 1 mod 32, so that reading a
    row along its columns and reading a column down its rows are both free
    of bank conflicts (``csrc/lstm_step.cuh``)."""
    return _round_up(gdc - 1, 32) + 1


def max_threads(rows_per_thread: int) -> int:
    """Threads a CTA may have at ``rows_per_thread`` rows a thread: the
    kernels' launch bounds (``lstm_step.cuh max_threads``)."""
    return 256 if rows_per_thread >= 8 else 512


def _smem_floats(d: int, gates: int, cluster: int, rows: int, backward: bool) -> int:
    """Floats of dynamic shared memory the resident-``w_h`` kernels use, as
    their layouts in ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu``: the
    ``w_h`` slice, ``h`` (double-buffered), and the threads' input slots
    (K2: also ``dz`` and, in a cluster, the ``dh`` partials)."""
    dc = -(-d // cluster)
    dcp = _round_up(dc, 32)
    n = _round_up(d * w_stride(gates * dc), 4) + 2 * rows * _round_up(d, 4)
    if not backward:
        return n + 2 * gates * rows * dcp
    n += rows * _round_up(gates * dc, 4) + 2 * (gates + 3) * rows * dcp
    return n + (2 * cluster * rows * dcp if cluster > 1 else 0)


def recurrence_candidates(
    b: int, d: int, gates: int, sms: int, smem_limit: int = SMEM_OPTIN, backward: bool = False
) -> List[Tuple[int, int, int, int]]:
    """Every ``(cluster, rows, threads, smem_bytes)`` with ``w_h`` resident
    in shared memory that fits ``smem_limit`` and the launch bounds, for
    ``b`` batch rows, ``d`` hidden units and ``gates`` gates on ``sms`` SMs:
    a cluster of 1, 2, 4 or 8 CTAs splits ``w_h`` by unit, each cluster
    walks ``rows`` batch rows (at most as many as fill the SMs in one wave),
    and a thread owns one unit of ``rows_per_thread`` (1, 2, 4 or 8) rows,
    ``threads = round_up(ceil(d / cluster), 32) * row_groups``."""
    b = max(b, 1)
    out = []
    for cluster in _CLUSTERS:
        dc = -(-d // cluster)
        if (cluster - 1) * dc >= d:  # a CTA would own no unit
            break
        dcp = _round_up(dc, 32)
        target = -(-b // max(1, sms // cluster))  # rows per cluster for one wave
        rt0 = min(8, 1 << (target - 1).bit_length())
        for rt in (1, 2, 4, 8):
            for groups in range(1, rt0 * -(-target // rt0) // rt + 1):
                smem = 4 * _smem_floats(d, gates, cluster, rt * groups, backward)
                if dcp * groups > max_threads(rt) or smem > smem_limit:
                    break
                out.append((cluster, rt * groups, dcp * groups, smem))
    return out


def rows_per_thread(d: int, cluster: int, rows: int, threads: int) -> int:
    """Rows a thread owns in a resident-``w_h`` geometry."""
    return rows * _round_up(-(-d // cluster), 32) // threads


@functools.lru_cache(maxsize=1024)  # the wrappers ask at every call; a pick costs ~0.1 ms of Python
def recurrence_geometry(
    b: int, d: int, gates: int, sms: int, smem_limit: int = SMEM_OPTIN, backward: bool = False
) -> Tuple[int, int, int, int, str]:
    """``(cluster, rows, threads, smem_bytes, route)`` of K1
    (``backward=False``) or K2's recurrence for ``b`` batch rows, ``d``
    hidden units and ``gates`` gates on a card of ``sms`` SMs.

    Route ``"smem"``: of :func:`recurrence_candidates`, the fewest CTAs a
    cluster; then the most rows (the fewest waves); then at least four
    warps, to hide the latency of each step's chains; then the most rows a
    thread (each ``w_h`` value read feeds rows_per_thread x G FMAs). Route
    ``"l2"``, where no cluster of 8 holds ``w_h`` (Normal ``d`` above ~330,
    Coupled above ~380): ``w_h`` read from global memory (L2), one thread
    per unit, ``cluster = 1``. Raises above ``d = 1024``."""
    if not 0 < d <= 1024:
        raise ValueError(f"the LSTM recurrence takes 0 < D <= 1024 (one thread per unit), got {d}")
    fits = recurrence_candidates(b, d, gates, sms, smem_limit, backward)
    if fits:
        least = min(c for c, _, _, _ in fits)
        _, _, _, cluster, rows, threads, smem = max(
            (rows, min(threads, _MIN_THREADS), rows_per_thread(d, c, rows, threads), c, rows, threads, smem)
            for c, rows, threads, smem in fits
            if c == least
        )
        return cluster, rows, threads, smem, "smem"
    threads = _round_up(d, 32)
    if not backward:
        return 1, _L2_FWD_ROWS, threads, 4 * _L2_FWD_ROWS * d, "l2"
    rows = 8 if b >= 16 * sms else 4 if b >= 8 * sms else 2  # about two blocks an SM
    return 1, rows, threads, 4 * rows * d * (gates + 2), "l2"


Geometry = Tuple[int, int, int, int, str]  # recurrence_geometry's result


def _geometry(b: int, d: int, gates: int, device: torch.device, backward: bool) -> Geometry:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return recurrence_geometry(b, d, gates, sms, backward=backward)


def _fwd_launch(
    xz: torch.Tensor, w_h: torch.Tensor, keep: torch.Tensor, coupled: bool, geometry: Geometry
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on checked inputs in ``geometry``; raises on a CUDA error."""
    t_len, b, _ = xz.shape
    d = w_h.shape[0]
    cluster, rows, threads, smem, route = geometry
    hidden = torch.empty((t_len, b, d), dtype=torch.float32, device=xz.device)
    cell = torch.empty_like(hidden)
    fn = _build.library().sbr_lstm_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xz.device):
        stream = torch.cuda.current_stream(xz.device).cuda_stream
        status = fn(
            xz.data_ptr(), w_h.data_ptr(), keep.data_ptr(), hidden.data_ptr(), cell.data_ptr(),
            t_len, b, d, int(coupled), cluster, rows, threads, smem, int(route == "smem"), stream,
        )
    _build.check(status, "lstm_fwd")
    return hidden, cell


def lstm_fwd(
    xz: torch.Tensor, w_h: torch.Tensor, keep: torch.Tensor, coupled: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`lstm_fwd_plain`, as the CUDA kernel for CUDA
    tensors, in the geometry of :func:`recurrence_geometry`.
    ``lstm_fwd.launches`` counts the kernel's launches."""
    if xz.device.type == "cpu":
        return lstm_fwd_plain(xz, w_h, keep, coupled)
    if xz.device.type != "cuda":
        raise ValueError(f"lstm_fwd runs on cuda or cpu, not {xz.device}")
    t_len, b, gd = xz.shape
    d = w_h.shape[0]
    gates = 3 if coupled else 4
    if gd != gates * d:
        raise ValueError(f"xz has {gd} gate columns, expected {gates} x {d}")
    _require(xz, "xz", (t_len, b, gd), torch.float32, xz.device)
    _require(w_h, "w_h", (d, gd), torch.float32, xz.device)
    _require(keep, "keep", (t_len, b, 1), torch.float32, xz.device)
    out = _fwd_launch(xz, w_h, keep, coupled, _geometry(b, d, gates, xz.device, backward=False))
    lstm_fwd.launches += 1
    return out


lstm_fwd.launches = 0


def lstm_bwd_plain(
    xz: torch.Tensor,
    w_h: torch.Tensor,
    hidden: torch.Tensor,
    cell: torch.Tensor,
    g: torch.Tensor,
    keep: torch.Tensor,
    coupled: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse time loop of the Pallas ``_bwd_kernel``: ``xz [T, B, G*D]``,
    ``hidden``/``cell`` of the forward and the incoming gradient ``g``, all
    ``[T, B, D]``, ``keep [T, B, 1]``. Gates are recomputed from ``xz[t]``
    and ``h[t-1] * factor``, ``factor = keep[t] * (t > 0)``, which also
    gates both adjoint carries. Returns ``(dxz, dW_h)``, f32."""
    t_len, b, _ = xz.shape
    d = w_h.shape[0]
    dxz = torch.empty_like(xz)
    dwh = torch.zeros_like(w_h)
    dh = xz.new_zeros((b, d))
    dc = xz.new_zeros((b, d))
    for t in range(t_len - 1, -1, -1):
        if t > 0:
            factor = keep[t]
            h_prev = hidden[t - 1] * factor
            c_prev = cell[t - 1] * factor
        else:
            factor = torch.zeros_like(keep[0])
            h_prev = c_prev = xz.new_zeros((b, d))
        z = xz[t] + h_prev @ w_h
        tc = torch.tanh(cell[t])
        dh_tot = g[t] + dh
        if coupled:
            zi, zg, zo = z.split(d, dim=-1)
            i, gg, o = torch.sigmoid(zi), torch.tanh(zg), torch.sigmoid(zo)
            dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
            dz = torch.cat([
                dc_tot * (gg - c_prev) * i * (1.0 - i),
                dc_tot * i * (1.0 - gg * gg),
                dh_tot * tc * o * (1.0 - o),
            ], dim=-1)
            dc_prev = dc_tot * (1.0 - i)
        else:
            zi, zf, zg, zo = z.split(d, dim=-1)
            i, f = torch.sigmoid(zi), torch.sigmoid(zf)
            gg, o = torch.tanh(zg), torch.sigmoid(zo)
            dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
            dz = torch.cat([
                dc_tot * gg * i * (1.0 - i),
                dc_tot * c_prev * f * (1.0 - f),
                dc_tot * i * (1.0 - gg * gg),
                dh_tot * tc * o * (1.0 - o),
            ], dim=-1)
            dc_prev = dc_tot * f
        dxz[t] = dz
        dh = (dz @ w_h.T) * factor
        dc = dc_prev * factor
        dwh += h_prev.T @ dz
    return dxz, dwh


def _bwd_launch(
    xz: torch.Tensor,
    w_h: torch.Tensor,
    hidden: torch.Tensor,
    cell: torch.Tensor,
    g: torch.Tensor,
    keep: torch.Tensor,
    coupled: bool,
    geometry: Geometry,
) -> torch.Tensor:
    """K2's recurrence on checked inputs in ``geometry``: ``dxz``; raises on
    a CUDA error."""
    t_len, b, _ = xz.shape
    cluster, rows, threads, smem, route = geometry
    dxz = torch.empty_like(xz)
    fn = _build.library().sbr_lstm_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xz.device):
        stream = torch.cuda.current_stream(xz.device).cuda_stream
        status = fn(
            xz.data_ptr(), w_h.data_ptr(), hidden.data_ptr(), cell.data_ptr(), g.data_ptr(),
            keep.data_ptr(), dxz.data_ptr(), t_len, b, w_h.shape[0], int(coupled), cluster, rows,
            threads, smem, int(route == "smem"), stream,
        )
    _build.check(status, "lstm_bwd")
    return dxz


def lstm_bwd(
    xz: torch.Tensor,
    w_h: torch.Tensor,
    hidden: torch.Tensor,
    cell: torch.Tensor,
    g: torch.Tensor,
    keep: torch.Tensor,
    coupled: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of :func:`lstm_bwd_plain`, as the CUDA kernels for CUDA
    tensors: the recurrence (geometry :func:`recurrence_geometry` with
    ``backward=True``) writes ``dxz``, then :func:`lstm_bwd_dwh` reduces
    ``dW_h``. ``lstm_bwd.launches`` counts the recurrence's launches."""
    if xz.device.type == "cpu":
        return lstm_bwd_plain(xz, w_h, hidden, cell, g, keep, coupled)
    if xz.device.type != "cuda":
        raise ValueError(f"lstm_bwd runs on cuda or cpu, not {xz.device}")
    t_len, b, gd = xz.shape
    d = w_h.shape[0]
    gates = 3 if coupled else 4
    if gd != gates * d:
        raise ValueError(f"xz has {gd} gate columns, expected {gates} x {d}")
    _require(xz, "xz", (t_len, b, gd), torch.float32, xz.device)
    _require(w_h, "w_h", (d, gd), torch.float32, xz.device)
    for name, x in (("hidden", hidden), ("cell", cell), ("g", g)):
        _require(x, name, (t_len, b, d), torch.float32, xz.device)
    _require(keep, "keep", (t_len, b, 1), torch.float32, xz.device)
    dxz = _bwd_launch(xz, w_h, hidden, cell, g, keep, coupled, _geometry(b, d, gates, xz.device, backward=True))
    lstm_bwd.launches += 1
    return dxz, lstm_bwd_dwh(hidden, keep, dxz)


lstm_bwd.launches = 0


def lstm_bwd_dwh_plain(hidden: torch.Tensor, keep: torch.Tensor, dxz: torch.Tensor) -> torch.Tensor:
    """``dW_h = sum over t >= 1 of (h[t-1] * keep[t])^T dxz[t]``, ``[D, G*D]``."""
    d, gd = hidden.shape[-1], dxz.shape[-1]
    h_prev = (hidden[:-1] * keep[1:]).reshape(-1, d)
    return h_prev.T @ dxz[1:].reshape(-1, gd)


_DWH_TILE_K, _DWH_TILE_C = 64, 128  # the kernel's output tile, [D] x [G*D]
_DWH_ROWS = 32  # the kernel's rows per stage: a split's rows are a multiple
_DWH_MIN_ROWS = 256  # fewest reduction rows worth a split of their own


def dwh_geometry(m: int, d: int, gd: int, slots: int) -> Tuple[int, int, int, int]:
    """``(splits, chunk, tiles_k, tiles_c)`` of the dW_h kernel for ``m``
    reduction rows and a ``[d, gd]`` result with ``slots`` blocks resident
    at once: ``tiles_k x tiles_c`` output tiles of 64 x 128, and the rows
    cut into ``splits`` chunks of ``chunk`` rows (a multiple of 32; the last
    may be short, none is empty), so that one wave of blocks fills as many
    slots as it can: a second, partial wave would double the time."""
    tiles_k, tiles_c = -(-d // _DWH_TILE_K), -(-gd // _DWH_TILE_C)
    splits = max(1, min(slots // (tiles_k * tiles_c), m // _DWH_MIN_ROWS))
    chunk = -(-max(m, 1) // splits)
    chunk = -(-chunk // _DWH_ROWS) * _DWH_ROWS
    return max(1, -(-m // chunk)), chunk, tiles_k, tiles_c


def _dwh_tickets(device: torch.device, tiles: int) -> torch.Tensor:
    """The dW_h kernel's per-tile tickets on ``device``: zeros, which every
    launch leaves zero again (the last block of a tile resets its own). Kept
    across calls so that a call launches the kernel and nothing else."""
    have = _dwh_tickets.cache.get(device)
    if have is None or have.numel() < tiles:
        have = torch.zeros((max(tiles, 64),), dtype=torch.int32, device=device)
        _dwh_tickets.cache[device] = have
    return have


_dwh_tickets.cache = {}


def lstm_bwd_dwh(hidden: torch.Tensor, keep: torch.Tensor, dxz: torch.Tensor) -> torch.Tensor:
    """:func:`lstm_bwd_dwh_plain` as the CUDA reduction kernel for CUDA
    tensors: 3xTF32 on the tensor cores, split over the ``(T-1)*B`` rows
    (:func:`dwh_geometry`), the partials summed in split order by the last
    block of each tile in the same launch. ``lstm_bwd_dwh.launches`` counts
    its launches."""
    if hidden.device.type == "cpu":
        return lstm_bwd_dwh_plain(hidden, keep, dxz)
    if hidden.device.type != "cuda":
        raise ValueError(f"lstm_bwd_dwh runs on cuda or cpu, not {hidden.device}")
    t_len, b, d = hidden.shape
    gd = dxz.shape[-1]
    _require(hidden, "hidden", (t_len, b, d), torch.float32, hidden.device)
    _require(keep, "keep", (t_len, b, 1), torch.float32, hidden.device)
    _require(dxz, "dxz", (t_len, b, gd), torch.float32, hidden.device)
    m = max(t_len - 1, 0) * b
    if m >= 2**31 or d * gd >= 2**31:
        raise ValueError(f"lstm_bwd_dwh takes fewer than 2^31 rows and D x G*D elements, got {m}, {d} x {gd}")
    sms = torch.cuda.get_device_properties(hidden.device).multi_processor_count
    splits, chunk, tiles_k, tiles_c = dwh_geometry(m, d, gd, sms)  # one block an SM
    out = torch.empty((d, gd), dtype=torch.float32, device=hidden.device)
    partial = out if splits == 1 else torch.empty((splits, d, gd), dtype=torch.float32, device=hidden.device)
    tickets = _dwh_tickets(hidden.device, tiles_k * tiles_c)
    fn = _build.library().sbr_lstm_bwd_dwh_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        status = fn(
            hidden.data_ptr(), keep.data_ptr(), dxz.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), t_len, b, d, gd, splits, chunk, stream,
        )
    _build.check(status, "lstm_bwd_dwh")
    lstm_bwd_dwh.launches += 1
    return out


lstm_bwd_dwh.launches = 0


class LSTMFunction(torch.autograd.Function):
    """The recurrence as one differentiable op, ``(xz, w_h, keep, coupled)
    -> hidden [T, B, D]``: :func:`lstm_fwd` forward, :func:`lstm_bwd`
    backward (the kernels on CUDA). Gradients flow to ``xz`` and ``w_h``;
    ``keep`` and ``coupled`` get none."""

    @staticmethod
    def forward(ctx, xz, w_h, keep, coupled):
        hidden, cell = lstm_fwd(xz, w_h, keep, coupled)
        ctx.save_for_backward(xz, w_h, hidden, cell, keep)
        ctx.coupled = coupled
        return hidden

    @staticmethod
    def backward(ctx, g):
        xz, w_h, hidden, cell, keep = ctx.saved_tensors
        dxz, dwh = lstm_bwd(xz, w_h, hidden, cell, g.contiguous(), keep, ctx.coupled)
        return dxz, dwh, None, None


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
    CUDA). ``starts [B, T]`` marks packed-window starts. The recurrence
    runs as :class:`LSTMFunction`, whose backward is :func:`lstm_bwd`;
    where no gradient is wanted (serving, ``torch.no_grad``) autograd
    builds no graph and nothing stays saved."""
    xz, keep = time_major_inputs(params, x, starts)
    hidden = LSTMFunction.apply(xz, params["w_h"], keep, coupled)
    return hidden.transpose(0, 1)
