"""Builds the CUDA kernels in ``csrc/`` and loads them with ``ctypes``.

All ``csrc/*.cu`` files compile with ``nvcc`` into one shared library with a
plain C interface, on the first CUDA use. The library lands in
``build/sbr_rs_tpu_torch/`` at the root of the checkout, named by a hash of
the sources and the flags, so an edited kernel rebuilds and an unchanged one
loads at once. Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception.

There is no fallback: without ``nvcc``, or when the build fails, the call
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sbr_rs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_library = None  # the loaded CDLL; the package's only global state


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing, or it refused the kernel sources."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install prefix. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of sbr_rs_tpu_torch cannot be built"
    )


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library, or reuse the one
    a previous call built from the same sources and flags. Returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libsbr_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.sbr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sbr_cuda_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(status: int, name: str) -> None:
    """Raise when a kernel's entry point reported a CUDA error."""
    if status != 0:
        msg = library().sbr_cuda_error_string(status).decode()
        raise KernelLaunchError(f"{name}: CUDA error {status} ({msg})")
