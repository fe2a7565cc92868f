"""Row traffic of the training step: CUDA kernels and their plain versions.

Counterparts of the Pallas probes of the JAX package's sparse step:

* :func:`gather_rows` -- ``out[i] = f32(table[clamp(idx[i], 0, N - 1)])``,
  ``scripts/row_pipeline_probe.py pl_gather`` (P1): the step's row gathers
  and ``sparse_update``'s row and state gathers (``csrc/row_gather.cu``);
* :func:`scatter_add_rows_` -- ``table[idx[i]] += delta[i]`` in place over
  unique in-range ids, others dropped, ``row_pipeline_probe.py pl_rmw``
  (P2): ``sparse_update``'s scatters of the table and its state (same
  source);
* :func:`cand_score` -- ``out[p, k] = <haug[p], table[cand[p, k]]>``, WARP's
  candidate gather + score, ``scripts/cand_gather_probe.py`` (P3
  ``_make_vmem``, the table on chip; P4 ``pallas_dma_rows``, rows from
  device memory): :func:`cand_score_smem` when the whole table fits one
  block's shared memory (staged by the bulk-copy engine), else
  :func:`cand_score_rows`
  (``csrc/cand_score.cu``).

Tables are f32 or bf16; gathered rows and scores are f32. For CUDA tensors
the wrappers launch the kernels and raise on input they do not take; for
CPU tensors, and only for those, they run the plain versions
(:func:`gather_rows_plain`, :func:`scatter_add_rows_plain`,
:func:`cand_score_plain`). Ids are int64. Each wrapper's ``launches``
counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lstm_kernels import _require
from .topk_kernels import _route

# Table bytes P3 stages in one block's shared memory on the H100 (sm_90):
# the 227 KB (232,448 bytes) a block may opt in to, less the 128 bytes
# that hold its mbarrier and up to 16 bytes of alignment (csrc/cand_score.cu).
SMEM_BYTES = 232_448 - 144
_FNS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _suffix(table: torch.Tensor, name: str) -> str:
    if table.dtype not in _FNS:
        raise ValueError(f"{name}: table must be float32 or bfloat16, got {table.dtype}")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: table must be a contiguous [N, C] tensor, got {list(table.shape)}")
    if table.shape[0] < 1:
        raise ValueError(f"{name}: the table has no rows")
    return _FNS[table.dtype]


def _vec(c: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """1 when every lane may move 16 bytes at a time: whole 16-byte groups
    per row, and every pointer 16-byte aligned."""
    return int(c % (16 // itemsize) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _call(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*args, stream)
    _build.check(status, name)


# -- P1: gather ------------------------------------------------------------------


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[M, C]`` f32 rows ``table[clamp(idx, 0, N - 1)]`` (``mode="clip"``)."""
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1)).to(torch.float32)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows_plain` as ``csrc/row_gather.cu`` for CUDA tensors:
    one warp per row, bf16 upcast in the kernel. ``idx``: int64 ``[M]``."""
    if not _route(table, "gather_rows"):
        return gather_rows_plain(table, idx)
    sfx = _suffix(table, "gather_rows")
    n, c = table.shape
    m = idx.shape[0]
    _require(idx, "gather_rows: idx", (m,), torch.int64, table.device)
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    fn = getattr(_build.library(), f"sbr_gather_rows_{sfx}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _call(
        fn, "gather_rows", table.device, table.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n, m, c, _vec(c, table.element_size(), table, out),
    )
    gather_rows.launches += 1
    return out


# -- P2: read-modify-write ---------------------------------------------------------


def scatter_add_rows_plain(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += delta[i]`` in place for ``0 <= idx[i] < N``; other
    ids are dropped (``mode="drop"``): ``index_add_`` of the kept rows.
    Returns ``table``."""
    keep = (idx >= 0) & (idx < table.shape[0])
    return table.index_add_(0, idx[keep], delta[keep])


def scatter_add_rows_(table: torch.Tensor, idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_add_rows_plain` as ``csrc/row_gather.cu`` for CUDA
    tensors. ``delta [M, C]`` is already in the table's dtype; each element
    is one f32 add rounded once to it. In-range ids must be unique (the
    kernel uses no atomics); the dropped ids may repeat. Returns ``table``."""
    if not _route(table, "scatter_add_rows_"):
        return scatter_add_rows_plain(table, idx, delta)
    sfx = _suffix(table, "scatter_add_rows_")
    n, c = table.shape
    m = idx.shape[0]
    _require(idx, "scatter_add_rows_: idx", (m,), torch.int64, table.device)
    _require(delta, "scatter_add_rows_: delta", (m, c), table.dtype, table.device)
    fn = getattr(_build.library(), f"sbr_scatter_add_rows_{sfx}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _call(
        fn, "scatter_add_rows_", table.device, table.data_ptr(), idx.data_ptr(), delta.data_ptr(),
        n, m, c, _vec(c, table.element_size(), table, delta),
    )
    scatter_add_rows_.launches += 1
    return table


# -- P3 / P4: candidate gather + score ------------------------------------------------


def cand_score_plain(haug: torch.Tensor, table: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``[P, K]`` f32 scores through the ``[P, K, C]`` gathered rows (the
    formulation of ``xla_baseline``: gather + einsum)."""
    p, k = cand.shape
    rows = gather_rows_plain(table, cand.reshape(-1)).reshape(p, k, table.shape[1])
    return torch.einsum("pe,pke->pk", haug, rows)


def cand_score_fits_smem(table: torch.Tensor) -> bool:
    """Whether the whole table fits one block's shared memory (P3's route)."""
    return table.numel() * table.element_size() <= SMEM_BYTES


def _cand_launch(haug, table, cand, name, route):
    sfx = _suffix(table, name)
    n, c = table.shape
    p, k = cand.shape
    _require(haug, f"{name}: haug", (p, c), torch.float32, table.device)
    _require(cand, f"{name}: cand", (p, k), torch.int64, table.device)
    out = torch.empty((p, k), dtype=torch.float32, device=table.device)
    fn = getattr(_build.library(), f"sbr_cand_score_{route}_{sfx}")
    args = [haug.data_ptr(), table.data_ptr(), cand.data_ptr(), out.data_ptr(), n, p, c, k]
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
    if route == "rows":
        args.append(_vec(c, table.element_size(), table, haug))
        argtypes.append(ctypes.c_int)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _call(fn, name, table.device, *args)
    return out


def cand_score_smem(haug: torch.Tensor, table: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """:func:`cand_score_plain` with the whole table staged in shared memory
    (P3), for CUDA tensors; the table must satisfy
    :func:`cand_score_fits_smem`. Each block stages the table by one bulk
    copy."""
    if not _route(table, "cand_score_smem"):
        return cand_score_plain(haug, table, cand)
    if not cand_score_fits_smem(table):
        raise ValueError(
            f"cand_score_smem: a {list(table.shape)} {table.dtype} table does not fit "
            f"{SMEM_BYTES} bytes of shared memory"
        )
    out = _cand_launch(haug, table, cand, "cand_score_smem", "smem")
    cand_score_smem.launches += 1
    return out


def cand_score_rows(haug: torch.Tensor, table: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """:func:`cand_score_plain` with each candidate row read from device
    memory (P4), for CUDA tensors: one warp per position."""
    if not _route(table, "cand_score_rows"):
        return cand_score_plain(haug, table, cand)
    out = _cand_launch(haug, table, cand, "cand_score_rows", "rows")
    cand_score_rows.launches += 1
    return out


def cand_score(haug: torch.Tensor, table: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``[P, K]`` f32 scores ``<haug[p], table[cand[p, k]]>``: P3 when the
    table fits shared memory, else P4 (by size alone). ``haug [P, C]`` f32,
    ``cand [P, K]`` int64."""
    if cand_score_fits_smem(table):
        return cand_score_smem(haug, table, cand)
    return cand_score_rows(haug, table, cand)


gather_rows.launches = 0
scatter_add_rows_.launches = 0
cand_score_smem.launches = 0
cand_score_rows.launches = 0
