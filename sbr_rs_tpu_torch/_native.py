"""ctypes bindings for the native (C++) data-layer backend.

The reference's data layer is native Rust (``src/data.rs``); this module
provides the equivalent native host path for the TPU framework: CSV
interaction parsing, stable CSR ordering, and padded-window extraction are
implemented in ``native/sbr_native.cpp`` and called through a C ABI.

The shared library is compiled on demand with ``g++ -O3 -march=native``
into ``build/sbr_rs_tpu_torch/`` at the root of the checkout (beside the
CUDA kernels), keyed by a hash of the source and the build machine —
rebuilds happen only when either changes. Every entry point has a
pure-numpy fallback in :mod:`.data`; set ``SBR_NO_NATIVE=1`` to force it.

A copy of :mod:`sbr_rs_tpu._native` (importing that module would load jax),
built from the same ``native/sbr_native.cpp``. This is host code for the
data layer, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "sbr_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sbr_rs_tpu_torch"
_ABI_VERSION = 3

_lib: "ctypes.CDLL | None" = None
_load_attempted = False


def _cache_dir() -> Path:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _BUILD_DIR


def _build(source: Path, out: Path) -> None:
    """Compile to a temp file, then atomically rename (same pattern as the
    dataset cache, reference ``src/datasets.rs:36-55``)."""
    fd, tmp = tempfile.mkstemp(dir=str(out.parent), suffix=".so")
    os.close(fd)
    try:
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared",
                "-fPIC", "-fvisibility=hidden", str(source), "-o", tmp,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_f32 = ctypes.POINTER(ctypes.c_float)

    lib.sbr_native_abi_version.restype = ctypes.c_int
    lib.sbr_native_abi_version.argtypes = []

    lib.sbr_csv_count_rows.restype = c_i64
    lib.sbr_csv_count_rows.argtypes = [ctypes.c_char_p]

    lib.sbr_csv_parse.restype = c_i64
    lib.sbr_csv_parse.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_i64, c_i64]

    lib.sbr_stable_order_by_user_ts.restype = None
    lib.sbr_stable_order_by_user_ts.argtypes = [c_i64, p_i64, p_i64, p_i64]

    lib.sbr_count_windows.restype = c_i64
    lib.sbr_count_windows.argtypes = [c_i64, p_i64, c_i64, c_i64]

    lib.sbr_fill_windows.restype = c_i64
    lib.sbr_fill_windows.argtypes = [
        c_i64, p_i64, p_i64, c_i64, c_i64, p_i32, p_i32, p_f32, p_i32, c_i64,
    ]

    lib.sbr_pack_plan.restype = c_i64
    lib.sbr_pack_plan.argtypes = [c_i64, p_i32, c_i64, p_i64, p_i64]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted or os.environ.get("SBR_NO_NATIVE"):
        return _lib
    _load_attempted = True
    try:
        src = _SOURCE.read_bytes()
        # The cache key must cover the build environment, not just the
        # source: -march=native binaries SIGILL when a shared $HOME moves to
        # a CPU without the build machine's ISA extensions.
        import platform

        try:
            gxx = subprocess.run(
                ["g++", "--version"], capture_output=True, timeout=10
            ).stdout
        except Exception:
            gxx = b""
        fingerprint = src + platform.machine().encode() + platform.processor().encode() + gxx
        digest = hashlib.sha256(fingerprint).hexdigest()[:16]
        so_path = _cache_dir() / f"sbr_native_{digest}.so"
        if not so_path.exists():
            _build(_SOURCE, so_path)
        lib = _declare(ctypes.CDLL(str(so_path)))
        if lib.sbr_native_abi_version() != _ABI_VERSION:
            return None
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# High-level wrappers (numpy in / numpy out); raise RuntimeError when the
# library is unavailable — callers are expected to check available() or
# catch and fall back.
# ---------------------------------------------------------------------------


def parse_interactions_csv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a ``user_id,item_id,rating,timestamp`` CSV (header skipped,
    rating ignored) into columnar int64 arrays."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = lib.sbr_csv_count_rows(str(path).encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    users = np.empty(n, dtype=np.int64)
    items = np.empty(n, dtype=np.int64)
    ts = np.empty(n, dtype=np.int64)
    got = lib.sbr_csv_parse(
        str(path).encode(),
        _ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64),
        _ptr(ts, ctypes.c_int64), n,
    )
    if got < 0:
        raise IOError(f"cannot parse {path}")
    return users[:got], items[:got], ts[:got]


def stable_order_by_user_ts(users: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
    """Stable argsort by (user_id, timestamp) — CSR compression order."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    users = np.ascontiguousarray(users, dtype=np.int64)
    timestamps = np.ascontiguousarray(timestamps, dtype=np.int64)
    order = np.empty(len(users), dtype=np.int64)
    lib.sbr_stable_order_by_user_ts(
        len(users), _ptr(users, ctypes.c_int64),
        _ptr(timestamps, ctypes.c_int64), _ptr(order, ctypes.c_int64),
    )
    return order


def extract_padded_windows(
    user_pointers: np.ndarray,
    item_ids: np.ndarray,
    max_sequence_length: int,
    min_length: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """First-chunk-smallest window extraction into padded [N, T] batches.

    Returns (inputs, targets, mask, lengths) with the exact semantics of
    :func:`.data.extract_padded_windows`.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    user_pointers = np.ascontiguousarray(user_pointers, dtype=np.int64)
    item_ids = np.ascontiguousarray(item_ids, dtype=np.int64)
    num_users = len(user_pointers) - 1
    t = int(max_sequence_length)
    n = lib.sbr_count_windows(
        num_users, _ptr(user_pointers, ctypes.c_int64), t, int(min_length)
    )
    inputs = np.empty((n, t), dtype=np.int32)
    targets = np.empty((n, t), dtype=np.int32)
    mask = np.empty((n, t), dtype=np.float32)
    lengths = np.empty((n,), dtype=np.int32)
    got = lib.sbr_fill_windows(
        num_users, _ptr(user_pointers, ctypes.c_int64),
        _ptr(item_ids, ctypes.c_int64), t, int(min_length),
        _ptr(inputs, ctypes.c_int32), _ptr(targets, ctypes.c_int32),
        _ptr(mask, ctypes.c_float), _ptr(lengths, ctypes.c_int32), n,
    )
    assert got == n, f"native window fill wrote {got} of {n} rows"
    return inputs, targets, mask, lengths


def pack_plan(
    sizes: np.ndarray, capacity: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """First-fit-decreasing bin plan over items of ``sizes`` into bins of
    ``capacity`` slots — the exact algorithm of
    :func:`.data._pack_plan_numpy` (items with size < 1 get
    ``bin_of = -1``). Returns (bin_of, offset_of, num_bins)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    n = len(sizes)
    bin_of = np.empty(n, dtype=np.int64)
    offset_of = np.empty(n, dtype=np.int64)
    m = lib.sbr_pack_plan(
        n, _ptr(sizes, ctypes.c_int32), int(capacity),
        _ptr(bin_of, ctypes.c_int64), _ptr(offset_of, ctypes.c_int64),
    )
    return bin_of, offset_of, int(m)
