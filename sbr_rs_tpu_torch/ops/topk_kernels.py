"""Catalog scoring fused with a reduction: CUDA kernels and their plain versions.

Counterpart of :mod:`sbr_rs_tpu.ops.pallas_topk`. Every entry point scores
table rows ``[C, Cc]`` (f32, or bf16 upcast inside the kernel) against
bias-augmented user representations ``reps_aug [U, Cc]`` (f32) and reduces
the scores on the chip, so the ``[C, U]`` score matrix never reaches
device memory.

Serving (phase 1 of the exact two-phase top-k in ``models/base.py``): a
score is ``-inf`` unless its row is inside the catalog (``lo + i < n``) and
inside the call (``i < C``), and only group maxima are kept:

* :func:`score_groupmax` -- maxima over groups of ``group`` rows, on the
  tensor cores in 3xTF32 (``csrc/score_submax_tc.cu``, its one-output
  mode), for the group-only routes: the running merge, one catalog chunk a
  call, and the group-only single pass; :func:`split_reps` splits the reps
  once for all the chunk calls of a batch;
* :func:`score_groupmax_fp32` -- the same maxima in FP32 FMAs
  (``csrc/score_groupmax.cu``), for the users those routes cannot certify;
* :func:`score_submax_groupmax` -- maxima over subgroups of ``sub`` rows
  and groups of ``group`` rows, from one pass, on the tensor cores in
  3xTF32 (``csrc/score_submax_tc.cu``);
* :func:`score_submax_groupmax_fp32` -- the same maxima in FP32 FMAs
  (``csrc/score_groupmax.cu``), which the serving path runs again for the
  users whose top-k the bound cannot certify.

The 3xTF32 kernels take one of two score tiles, chosen by
:func:`submax_tile` from the row width, the row dtype and the card's
opt-in shared memory: table rows on the wgmma's N axis for narrow rows
(the LSTM-32 catalog's 33 floats), else on its M axis. Each wrapper's
``tile_launches`` counts its launches by tile (:data:`TILES`).

:func:`phase1_error_bound` bounds how far the 3xTF32 scores may lie from
the FP32 scores that phase 2 recomputes (both 3xTF32 kernels do the same
arithmetic). All four return :func:`groupmax_rows` rows, the rows past ``C`` all
``-inf``, as the TPU functions do.

Evaluation (the fused rank counter of ``evaluation.py``):

* :func:`score_count_ge` -- per user, the number of valid rows whose score
  is ``>= targets[u]`` and the score of one probe row
  (``csrc/score_count.cu``).

For CUDA tensors the wrappers launch the kernels and raise on input they
do not take; for CPU tensors, and only for those, they run the plain
versions (:func:`score_groupmax_plain`, :func:`score_submax_groupmax_plain`,
:func:`score_count_ge_plain`). The 3xTF32 kernels (``csrc/tf32x3.cuh``: each
f32 operand split into two TF32 parts, three products per term, on the
tiles of ``csrc/score_tile.cuh``) give scores within a few 1e-6 of FP32's;
the plain versions are FP32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_R_BLK = 2048  # output rows pad to this many table rows (the TPU row block)
_WIDTHS = (8, 16, 32, 64, 128)
# The widest table row (embedding and bias, f32 or bf16) the score kernels
# K3, K4 and K5 take: their tiles stage at most this many columns.
MAX_ROW_FLOATS = 512
# K3's and K4's two score tiles (``csrc/score_submax_tc.cu``), by the number
# their C entry points take: table rows on the wgmma's M axis (any width),
# or on its N axis (narrow rows, where its shared memory fits).
TILES = ("rows_on_m", "rows_on_n")


def rows_on_n_smem_bytes(cc: int, itemsize: int) -> int:
    """Shared memory of a rows-on-N block for rows of ``cc`` elements of
    ``itemsize`` bytes, the one count of it: the C entry points launch the
    tile with this many bytes, the sum of the regions ``narrow::run`` in
    ``csrc/score_tile.cuh`` lays out. The block's 256 rows split into TF32
    hi and lo (hi alone for bf16, exact in TF32) at depth
    ``round_up(cc, 8)``, two 64-user tiles of split reps for each of its
    two warpgroup pairs, the next block's raw rows and 16 bytes more, and
    96 bytes of barriers."""
    depth = -(-cc // 8) * 8
    rows = (1 if itemsize == 2 else 2) * 256 * depth * 4
    ring = 2 * 2 * (2 * 64 * depth * 4)
    return rows + ring + 256 * cc * itemsize + 16 + 96


def submax_tile(cc: int, rows_dtype: torch.dtype, smem_optin: int) -> int:
    """The tile (an index of :data:`TILES`) that K3 and K4 take for rows of
    width ``cc`` and ``rows_dtype`` on a card whose blocks may opt in to
    ``smem_optin`` bytes of shared memory: rows on N where its shared
    memory fits, else rows on M. On the H100 (232,448 bytes) rows on N
    take ``cc <= 40`` in f32 and ``cc <= 64`` in bf16."""
    return int(rows_on_n_smem_bytes(cc, rows_dtype.itemsize) <= smem_optin)


@functools.lru_cache(maxsize=None)
def _card_tile(cc: int, rows_dtype: torch.dtype, dev: torch.device) -> Tuple[int, int]:
    """``(tile, smem)`` on the card ``dev``: :func:`submax_tile`, and the
    shared memory a block of rows on N takes (0 for rows on M)."""
    lib = _build.library()
    lib.sbr_smem_per_block_optin.argtypes = []
    lib.sbr_smem_per_block_optin.restype = ctypes.c_int
    with torch.cuda.device(dev):
        tile = submax_tile(cc, rows_dtype, lib.sbr_smem_per_block_optin())
    return tile, rows_on_n_smem_bytes(cc, rows_dtype.itemsize) if tile else 0


class SplitReps(NamedTuple):
    """:func:`split_reps`'s result: the split reps and the tile (an index
    of :data:`TILES`) whose layout they are in."""

    scratch: torch.Tensor
    tile: int


def groupmax_supported(c: int, cc: int, u: int, group: int) -> bool:
    """Shapes the kernel takes: a group width in {8, 16, 32, 64, 128} (it
    divides the kernel's 128-row tile), ``Cc <= 512`` and at least one
    user. Any ``c`` works: ragged tails are masked inside the kernel."""
    return group in _WIDTHS and cc <= MAX_ROW_FLOATS and u >= 1


def groupmax_rows(c: int, group: int) -> int:
    """Rows :func:`score_groupmax` returns for ``c`` table rows."""
    return -(-c // _R_BLK) * _R_BLK // group


def score_groupmax_plain(
    chunk_rows: torch.Tensor, reps_aug: torch.Tensor, lo: int, n: int, group: int
) -> torch.Tensor:
    """``[ceil(C / group), U]`` group maxima through a ``[C, U]`` score
    matrix (the formulation of ``score_groupmax_xla``; a ragged tail is
    padded with ``-inf`` rows up to a whole group)."""
    c = chunk_rows.shape[0]
    u = reps_aug.shape[0]
    st = chunk_rows.to(torch.float32) @ reps_aug.T  # [C, U]
    ids = lo + torch.arange(c, device=st.device)
    st.masked_fill_((ids >= n)[:, None], float("-inf"))
    pad = -c % group
    if pad:
        st = torch.cat([st, st.new_full((pad, u), float("-inf"))])
    return st.reshape(-1, group, u).amax(dim=1)


def score_submax_groupmax_plain(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    lo: int,
    n: int,
    sub: int,
    group: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(subgroup maxima, group maxima)`` (the formulation of
    ``score_submax_groupmax_xla``); a ragged tail pads to a whole group."""
    c = chunk_rows.shape[0]
    pad = -c % group
    smax = score_groupmax_plain(chunk_rows, reps_aug, lo, n, sub)
    if pad:
        # Rows past C up to the group boundary: -inf subgroups.
        extra = (c + pad) // sub - smax.shape[0]
        smax = torch.cat([smax, smax.new_full((extra, smax.shape[1]), float("-inf"))])
    gmax = smax.reshape(-1, group // sub, smax.shape[1]).amax(dim=1)
    return smax, gmax


def _pad_to(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with ``-inf`` rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0], x.shape[1]), float("-inf"))])


def _launch(chunk_rows, reps_aug, lo, n, w1, w2, name):
    """Checks the operands, allocates the outputs and launches the kernel
    (one output at width ``w1``, or two when ``w2`` is given)."""
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    dev = chunk_rows.device
    if reps_aug.device != dev:
        raise ValueError(f"{name}: reps_aug is on {reps_aug.device}, rows on {dev}")
    if chunk_rows.dtype == torch.float32:
        fn = _build.library().sbr_score_groupmax_f32
    elif chunk_rows.dtype == torch.bfloat16:
        fn = _build.library().sbr_score_groupmax_bf16
    else:
        raise ValueError(f"{name}: rows must be float32 or bfloat16, got {chunk_rows.dtype}")
    if reps_aug.dtype != torch.float32 or tuple(reps_aug.shape) != (u, cc):
        raise ValueError(
            f"{name}: reps_aug must be float32 [{u}, {cc}], got "
            f"{reps_aug.dtype} {tuple(reps_aug.shape)}"
        )
    if not (chunk_rows.is_contiguous() and reps_aug.is_contiguous()):
        raise ValueError(f"{name}: rows and reps_aug must be contiguous")
    out1 = torch.empty((groupmax_rows(c, w1), u), dtype=torch.float32, device=dev)
    out2 = None
    if w2 is not None:
        out2 = torch.empty((groupmax_rows(c, w2), u), dtype=torch.float32, device=dev)
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            chunk_rows.data_ptr(), reps_aug.data_ptr(), out1.data_ptr(),
            None if out2 is None else out2.data_ptr(),
            c, cc, u, int(lo), int(n), w1, w2 or 0, int(out2 is not None), stream,
        )
    _build.check(status, name)
    return out1, out2


def _route(chunk_rows: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); raises for any other device."""
    if chunk_rows.device.type == "cuda":
        return True
    if chunk_rows.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu, not {chunk_rows.device}")


def _check_groupmax(chunk_rows, reps_aug, group, name) -> bool:
    """Raises on shapes the kernels do not take; True for the kernel (CUDA
    tensors), False for the plain version (CPU tensors)."""
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    if not groupmax_supported(c, cc, u, group):
        raise ValueError(f"{name} does not take group={group}, Cc={cc}, U={u}")
    return _route(chunk_rows, name)


def _groupmax_plain(chunk_rows, reps_aug, lo, n, group):
    out = score_groupmax_plain(chunk_rows, reps_aug, lo, n, group)
    return _pad_to(out, groupmax_rows(chunk_rows.shape[0], group))


def _scratch_floats(u: int, cc: int, tile: int) -> int:
    """Floats of the split reps of ``u`` users of width ``cc`` in the layout
    of ``tile`` (``csrc/score_tile.cuh``; rows on M is K5's too)."""
    lib = _build.library()
    lib.sbr_score_submax_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.sbr_score_submax_scratch_floats.restype = ctypes.c_longlong
    return lib.sbr_score_submax_scratch_floats(u, cc, tile)


def _split_reps_scratch(u: int, cc: int, dev: torch.device, tile: int = 0) -> torch.Tensor:
    """The scratch a 3xTF32 kernel splits ``reps_aug [u, cc]`` into."""
    return torch.empty((_scratch_floats(u, cc, tile),), dtype=torch.float32, device=dev)


def _check_reps(reps_aug, u, cc, dev, name) -> None:
    if reps_aug.device != dev or reps_aug.dtype != torch.float32 or tuple(reps_aug.shape) != (u, cc):
        raise ValueError(
            f"{name}: reps_aug must be float32 [{u}, {cc}] on {dev}, got "
            f"{reps_aug.dtype} {tuple(reps_aug.shape)} on {reps_aug.device}"
        )
    if not reps_aug.is_contiguous():
        raise ValueError(f"{name}: reps_aug must be contiguous")


def split_reps(reps_aug: torch.Tensor, rows_dtype: torch.dtype) -> Optional[SplitReps]:
    """``reps_aug [U, Cc]`` split into TF32 hi and lo parts in the layout
    of the tile :func:`score_groupmax` takes for rows of ``rows_dtype``
    (:func:`submax_tile`; ``csrc/score_tile.cuh``), with that tile
    (:class:`SplitReps`; :func:`score_groupmax` refuses it for rows that
    take the other), for its ``split``: the
    running merge splits once per batch, not once per chunk call. CPU
    tensors need no split (the plain version reads ``reps_aug``) and get
    ``None``. The split is K3's prologue, as it is inside K4's and K5's
    calls, so it has no launch counter of its own."""
    if not _route(reps_aug, "split_reps"):
        return None
    u, cc = reps_aug.shape
    _check_reps(reps_aug, u, cc, reps_aug.device, "split_reps")
    tile, _ = _card_tile(cc, rows_dtype, reps_aug.device)
    scratch = _split_reps_scratch(u, cc, reps_aug.device, tile)
    fn = _build.library().sbr_score_tile_split
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(reps_aug.device):
        stream = torch.cuda.current_stream(reps_aug.device).cuda_stream
        status = fn(reps_aug.data_ptr(), scratch.data_ptr(), u, cc, tile, stream)
    _build.check(status, "split_reps")
    return SplitReps(scratch, tile)


def _check_split(split, u: int, cc: int, dev: torch.device, tile: int, rows_dtype: torch.dtype) -> None:
    """Refuse a ``split`` that is not :func:`split_reps` of float32
    ``[u, cc]`` reps on ``dev`` in the layout of ``tile``, the tile that
    rows of ``rows_dtype`` take. The two layouts may hold as many floats
    (both ``2 u cc`` where 128 divides ``u`` and 16 divides ``cc``), so the
    tile is checked before the size."""
    what = f"score_groupmax: split is not split_reps of float32 [{u}, {cc}] reps on {dev} for {rows_dtype} rows"
    if not isinstance(split, SplitReps):
        raise ValueError(f"{what}: got {type(split).__name__}")
    if split.tile != tile:
        raise ValueError(f"{what}: it is laid out for {TILES[split.tile]}, these rows take {TILES[tile]}")
    s = split.scratch
    if s.device != dev or s.dtype != torch.float32 or s.ndim != 1 or s.numel() != _scratch_floats(u, cc, tile):
        raise ValueError(what)


def score_groupmax(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    lo: int,
    n: int,
    group: int,
    split: Optional[SplitReps] = None,
) -> torch.Tensor:
    """``[groupmax_rows(C, group), U]`` group maxima (module docstring).
    ``chunk_rows`` may be the whole catalog (``lo = 0``) or any slab of it.
    On the card the scores are 3xTF32 (``csrc/score_submax_tc.cu``), within
    :func:`phase1_error_bound` of the FP32 scores, from ``split``:
    :func:`split_reps` of these ``reps_aug`` for rows of this dtype, done
    here when not given. ``score_groupmax.launches`` counts the kernel's
    launches, ``score_groupmax.tile_launches`` them by tile."""
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    if not _check_groupmax(chunk_rows, reps_aug, group, "score_groupmax"):
        return _groupmax_plain(chunk_rows, reps_aug, lo, n, group)
    dev = chunk_rows.device
    if chunk_rows.dtype == torch.float32:
        fn = _build.library().sbr_score_groupmax_tc_f32
    elif chunk_rows.dtype == torch.bfloat16:
        fn = _build.library().sbr_score_groupmax_tc_bf16
    else:
        raise ValueError(f"score_groupmax: rows must be float32 or bfloat16, got {chunk_rows.dtype}")
    _check_reps(reps_aug, u, cc, dev, "score_groupmax")
    if not chunk_rows.is_contiguous():
        raise ValueError("score_groupmax: rows must be contiguous")
    tile, smem = _card_tile(cc, chunk_rows.dtype, dev)
    if split is None:
        split = split_reps(reps_aug, chunk_rows.dtype)
    else:
        _check_split(split, u, cc, dev, tile, chunk_rows.dtype)
    gmax = torch.empty((groupmax_rows(c, group), u), dtype=torch.float32, device=dev)
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            chunk_rows.data_ptr(), split.scratch.data_ptr(), gmax.data_ptr(), c, cc, u, int(lo), int(n), group,
            tile, smem, stream,
        )
    _build.check(status, "score_groupmax")
    score_groupmax.launches += 1
    score_groupmax.tile_launches[TILES[tile]] += 1
    return gmax


def score_groupmax_fp32(
    chunk_rows: torch.Tensor, reps_aug: torch.Tensor, lo: int, n: int, group: int
) -> torch.Tensor:
    """:func:`score_groupmax` with FP32 scores (``csrc/score_groupmax.cu``,
    FP32 FMAs outside the tensor cores). ``score_groupmax_fp32.launches``
    counts the kernel's launches."""
    if not _check_groupmax(chunk_rows, reps_aug, group, "score_groupmax_fp32"):
        return _groupmax_plain(chunk_rows, reps_aug, lo, n, group)
    out, _ = _launch(chunk_rows, reps_aug, lo, n, group, None, "score_groupmax_fp32")
    score_groupmax_fp32.launches += 1
    return out


def _check_submax(chunk_rows, reps_aug, sub, group, name) -> None:
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    if group % sub or sub >= group:
        raise ValueError(f"sub={sub} must be a proper divisor of group={group}")
    if not (groupmax_supported(c, cc, u, sub) and groupmax_supported(c, cc, u, group)):
        raise ValueError(f"{name} does not take sub={sub}, group={group}, Cc={cc}, U={u}")


def _submax_plain(chunk_rows, reps_aug, lo, n, sub, group):
    c = chunk_rows.shape[0]
    smax, gmax = score_submax_groupmax_plain(chunk_rows, reps_aug, lo, n, sub, group)
    return _pad_to(smax, groupmax_rows(c, sub)), _pad_to(gmax, groupmax_rows(c, group))


def score_submax_groupmax(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    lo: int,
    n: int,
    sub: int,
    group: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([groupmax_rows(C, sub), U], [groupmax_rows(C, group), U])``
    subgroup and group maxima from one pass; ``sub`` divides ``group``. On
    the card the scores are 3xTF32 (``csrc/score_submax_tc.cu``; a pre-pass
    in the same call splits ``reps_aug`` into a scratch buffer), within
    :func:`phase1_error_bound` of the FP32 scores phase 2 computes.
    ``score_submax_groupmax.launches`` counts the calls that launch it,
    ``score_submax_groupmax.tile_launches`` them by tile."""
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    _check_submax(chunk_rows, reps_aug, sub, group, "score_submax_groupmax")
    if not _route(chunk_rows, "score_submax_groupmax"):
        return _submax_plain(chunk_rows, reps_aug, lo, n, sub, group)
    dev = chunk_rows.device
    if chunk_rows.dtype == torch.float32:
        fn = _build.library().sbr_score_submax_tc_f32
    elif chunk_rows.dtype == torch.bfloat16:
        fn = _build.library().sbr_score_submax_tc_bf16
    else:
        raise ValueError(f"score_submax_groupmax: rows must be float32 or bfloat16, got {chunk_rows.dtype}")
    _check_reps(reps_aug, u, cc, dev, "score_submax_groupmax")
    if not chunk_rows.is_contiguous():
        raise ValueError("score_submax_groupmax: rows must be contiguous")
    tile, smem = _card_tile(cc, chunk_rows.dtype, dev)
    scratch = _split_reps_scratch(u, cc, dev, tile)
    smax = torch.empty((groupmax_rows(c, sub), u), dtype=torch.float32, device=dev)
    gmax = torch.empty((groupmax_rows(c, group), u), dtype=torch.float32, device=dev)
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            chunk_rows.data_ptr(), reps_aug.data_ptr(), scratch.data_ptr(), smax.data_ptr(),
            gmax.data_ptr(), c, cc, u, int(lo), int(n), sub, group, tile, smem, stream,
        )
    _build.check(status, "score_submax_groupmax")
    score_submax_groupmax.launches += 1
    score_submax_groupmax.tile_launches[TILES[tile]] += 1
    return smax, gmax


def score_submax_groupmax_fp32(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    lo: int,
    n: int,
    sub: int,
    group: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_submax_groupmax` with FP32 scores
    (``csrc/score_groupmax.cu``, FP32 FMAs outside the tensor cores).
    ``score_submax_groupmax_fp32.launches`` counts the kernel's launches."""
    _check_submax(chunk_rows, reps_aug, sub, group, "score_submax_groupmax_fp32")
    if not _route(chunk_rows, "score_submax_groupmax_fp32"):
        return _submax_plain(chunk_rows, reps_aug, lo, n, sub, group)
    smax, gmax = _launch(chunk_rows, reps_aug, lo, n, sub, group, "score_submax_groupmax_fp32")
    score_submax_groupmax_fp32.launches += 1
    return smax, gmax


# -- the error bound of phase 1 ----------------------------------------------

_U32 = 2.0**-24  # the unit roundoff of FP32


def _gamma_fp32(m: int) -> float:
    """Higham's ``gamma_m = m u / (1 - m u)``: an FP32 dot of ``m`` terms,
    in any order of summation, lies within ``gamma_m * sum |a_k b_k|`` of
    the exact one."""
    return m * _U32 / (1.0 - m * _U32)


def phase1_gamma(cc: int, rows_dtype: torch.dtype, tensor_cores: bool) -> float:
    """``gamma`` of :func:`phase1_error_bound`: the factor of ``sum_k
    |rows_k| |reps_k|`` that bounds |phase-1 score - phase-2 score| for rows
    of width ``cc``. Phase 2 is an FP32 dot (``gamma_cc``). Phase 1 is
    either FP32 too (the plain version, ``tensor_cores=False``), or 3xTF32
    (``csrc/score_submax_tc.cu``, which derives the terms): the split's
    dropped part, ``3 * 2^-22 (1 + 2^-10)`` for f32 rows and ``2^-22 (1 +
    2^-10)`` for bf16 rows (exact in TF32), plus the truncating accumulation
    of ``P = 3`` (or 2) exact TF32 products a term, each entering the FP32
    accumulator through at most two truncations (its alignment, and the
    normalisation of the sum it joins) of at most ``2^-23`` of a running
    magnitude below ``(1 + 2^-8)`` times the sum: ``P * cc * 2^-22 (1 +
    2^-8)``."""
    if not tensor_cores:
        return 2.0 * _gamma_fp32(cc)
    exact_rows = rows_dtype == torch.bfloat16
    products = 2 if exact_rows else 3
    split = (1 if exact_rows else 3) * 2.0**-22 * (1 + 2.0**-10)
    accumulation = products * cc * 2.0**-22 * (1 + 2.0**-8)
    return split + accumulation + _gamma_fp32(cc)


def phase1_error_bound(table: torch.Tensor, reps_aug: torch.Tensor) -> torch.Tensor:
    """``eps [U]`` (f32): for every row ``i`` of ``table [N, Cc]``, the
    score :func:`score_submax_groupmax` or :func:`score_groupmax` gives
    user ``u`` lies within
    ``eps[u]`` of the FP32 score ``rows[i] . reps_aug[u]`` that phase 2
    recomputes: ``eps[u] = gamma * sum_k |reps_aug[u, k]| M_k`` with ``M_k =
    max_i |table[i, k]|`` and ``gamma`` from :func:`phase1_gamma` (3xTF32
    on the card, FP32 for CPU tensors, whose phase 1 is the plain FP32
    version). Derived, not fitted: the serving path certifies its top-k
    with it. Rounded up to the next f32."""
    cc = table.shape[1]
    gamma = phase1_gamma(cc, table.dtype, tensor_cores=table.device.type == "cuda")
    # M_k from one aminmax over the rows (abs() would copy the table).
    lo, hi = torch.aminmax(table, dim=0)
    m = torch.maximum(lo.abs(), hi.abs()).to(torch.float64)
    eps = (reps_aug.to(torch.float64).abs() @ m * gamma).to(torch.float32)
    return torch.nextafter(eps, torch.full_like(eps, float("inf")))


def count_supported(c: int, cc: int, u: int) -> bool:
    """Shapes :func:`score_count_ge` takes: ``Cc <= 512`` and at least one
    user. Any ``c`` works: a ragged tail is masked inside the kernel."""
    return cc <= MAX_ROW_FLOATS and u >= 1


def score_count_ge_plain(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    targets: torch.Tensor,
    probe_local: torch.Tensor,
    lo: int,
    col_lo: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts [U] int32, probe_scores [U] f32)`` through a ``[C, U]``
    score matrix (the formulation of ``score_count_ge_xla``): ``counts[u]``
    is the number of rows ``i`` with ``lo + i < n`` and ``i >= col_lo``
    whose score is ``>= targets[u]``; ``probe_scores[u]`` is the score of
    row ``clamp(probe_local[u], 0, C - 1)``."""
    c = chunk_rows.shape[0]
    u = reps_aug.shape[0]
    st = chunk_rows.to(torch.float32) @ reps_aug.T  # [C, U]
    local = torch.arange(c, device=st.device)
    valid = ((lo + local) < n) & (local >= col_lo)
    counts = ((st >= targets[None, :]) & valid[:, None]).sum(dim=0, dtype=torch.int32)
    probe = probe_local.to(torch.int64).clamp(0, c - 1)
    return counts, st[probe, torch.arange(u, device=st.device)]


def score_count_ge(
    chunk_rows: torch.Tensor,
    reps_aug: torch.Tensor,
    targets: torch.Tensor,
    probe_local: torch.Tensor,
    lo: int,
    col_lo: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_count_ge_plain` fused: ``csrc/score_count.cu`` for CUDA
    tensors (3xTF32 on the tensor cores; a pre-pass in the same call splits
    ``reps_aug`` into a scratch buffer). ``chunk_rows`` may be the whole
    catalog (``lo = col_lo = 0``) or any slab of it; any ``U`` works.
    ``C = 0`` returns zeros without a launch. ``score_count_ge.launches``
    counts the calls that launch the kernel."""
    c, cc = chunk_rows.shape
    u = reps_aug.shape[0]
    if not count_supported(c, cc, u):
        raise ValueError(f"score_count_ge does not take Cc={cc}, U={u}")
    on_cuda = _route(chunk_rows, "score_count_ge")
    dev = chunk_rows.device
    if c == 0:
        return (torch.zeros((u,), dtype=torch.int32, device=dev),
                torch.zeros((u,), dtype=torch.float32, device=dev))
    if not on_cuda:
        return score_count_ge_plain(chunk_rows, reps_aug, targets, probe_local, lo, col_lo, n)
    if chunk_rows.dtype == torch.float32:
        fn = _build.library().sbr_score_count_f32
    elif chunk_rows.dtype == torch.bfloat16:
        fn = _build.library().sbr_score_count_bf16
    else:
        raise ValueError(f"score_count_ge: rows must be float32 or bfloat16, got {chunk_rows.dtype}")
    for name, x, dtype, shape in (
        ("reps_aug", reps_aug, torch.float32, (u, cc)),
        ("targets", targets, torch.float32, (u,)),
        ("probe_local", probe_local, torch.int64, (u,)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"score_count_ge: {name} must be a contiguous {dtype} {list(shape)} on {dev}, "
                f"got {x.dtype} {list(x.shape)} on {x.device}"
            )
    if not chunk_rows.is_contiguous():
        raise ValueError("score_count_ge: rows must be contiguous")
    counts = torch.zeros((u,), dtype=torch.int32, device=dev)
    probe_scores = torch.empty((u,), dtype=torch.float32, device=dev)
    scratch = _split_reps_scratch(u, cc, dev)
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            chunk_rows.data_ptr(), reps_aug.data_ptr(), scratch.data_ptr(), targets.data_ptr(),
            probe_local.data_ptr(), counts.data_ptr(), probe_scores.data_ptr(),
            c, cc, u, int(lo), int(col_lo), int(n), stream,
        )
    _build.check(status, "score_count_ge")
    score_count_ge.launches += 1
    return counts, probe_scores


score_groupmax.launches = 0
score_groupmax.tile_launches = dict.fromkeys(TILES, 0)
score_groupmax_fp32.launches = 0
score_submax_groupmax.launches = 0
score_submax_groupmax.tile_launches = dict.fromkeys(TILES, 0)
score_submax_groupmax_fp32.launches = 0
score_count_ge.launches = 0
