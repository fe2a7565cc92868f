"""Builds the CUDA kernels in ``csrc/`` and loads them with ``ctypes``.

All ``csrc/*.cu`` files compile with ``nvcc`` into one shared library with a
plain C interface, on the first CUDA use: one ``nvcc`` per source, all
started together, then one link, so the build takes about as long as its
slowest file. The library lands in
``build/sbr_rs_tpu_torch/`` at the root of the checkout, named by a hash of
the sources, the headers they include (``csrc/*.cuh``) and the flags
(:func:`source_digest`), so an edited kernel or header rebuilds and an
unchanged tree loads at once. Every C entry point returns ``cudaGetLastError()`` after its
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def source_digest(csrc: Path = CSRC) -> str:
    """A hash of the flags and of every ``*.cu`` and ``*.cuh`` file in
    ``csrc`` (names and contents), which names the built library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library, or reuse the one
    a previous call built from the same sources, headers and flags. Returns
    its path."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libsbr_kernels_{source_digest()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objects = [out.with_name(f"{out.stem}.{os.getpid()}.{src.stem}.o") for src in sources]
    procs = []
    try:
        for src, obj in zip(sources, objects):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        for cmd, proc in procs:
            log = proc.communicate()[0]
            _check_nvcc(cmd, proc.returncode, log)
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _check_nvcc(cmd, link.returncode, link.stdout)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        for _, proc in procs:
            if proc.poll() is None:  # a sibling failed first
                proc.kill()
                proc.communicate()
        for path in (tmp, *objects):
            path.unlink(missing_ok=True)
    return out


def _check_nvcc(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise KernelCompileError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{log}")


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
