"""flax's ``state.msgpack`` format, read and written without ``msgpack``,
``flax`` or ``ml_dtypes``.

The JAX package saves a checkpoint's state with
``flax.serialization.msgpack_serialize``. What that writes is plain msgpack
with three conventions of flax's:

* an array leaf is an extension of type 1 whose payload is itself msgpack:
  ``[shape, dtype name, raw C-order bytes]`` (type 3, "npscalar", holds a
  numpy scalar the same way; type 2 a Python complex as ``[real, imag]``);
* a leaf of more than ``MAX_CHUNK_SIZE`` bytes (2**30) is replaced by the
  dict ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat chunk, ...}}`` of flat chunks of at most that many
  bytes, because a msgpack object cannot exceed 2**31 - 1 bytes. flax looks
  for such leaves in dicts only and never descends into lists, so an array
  inside a list is written whole (attention's per-layer lists);
* dict keys are written sorted (flax copies the tree with
  ``jax.tree_util.tree_map``, which rebuilds dicts with sorted keys); the
  chunked dicts, made after that copy, keep the order above.

:func:`write` produces the bytes flax produces for the same tree, from torch
tensors (on any device) or numpy arrays. It streams: a leaf is copied to the
host and written a piece of ``PIECE_BYTES`` at a time, so the host never
holds the whole blob, and the sha256 of the bytes is computed as they are
written. :func:`read` parses such a file as it hashes it and places each
array straight onto a device. bfloat16 travels as its bits under the dtype
name ``bfloat16``, as flax writes it with ``ml_dtypes``.
"""

from __future__ import annotations

import hashlib
import math
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
# Host bytes a leaf moves at a time, on its way to or from the file.
PIECE_BYTES = 64 << 20
# Bytes read ahead for the small objects between arrays.
_READ_AHEAD = 1 << 16

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

# -- the msgpack encoding of headers and scalars -----------------------------

# (fixed-size prefix and its limit, or None; the wider forms in order)
_STR = ((0xA0, 32), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
_BIN = (None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
_ARRAY = ((0x90, 16), ((0xDC, ">H"), (0xDD, ">I")))
_MAP = ((0x80, 16), ((0xDE, ">H"), (0xDF, ">I")))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))


def _sized(n: int, form) -> bytes:
    fix, wide = form
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} is too long for a msgpack object")


def _ext_header(n: int, ext_type: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], ext_type])
    for code, fmt in _EXT:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n) + bytes([ext_type])
    raise ValueError(f"an extension of {n} bytes is too long for msgpack")


def _int(x: int) -> bytes:
    """The smallest msgpack form of ``x``, as msgpack's packer picks it."""
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    forms = (
        ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if x >= 0
        else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    )
    for code, fmt in forms:
        bits = 8 * struct.calcsize(fmt)
        if (x < 1 << bits) if x >= 0 else (x >= -(1 << (bits - 1))):
            return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"{x} does not fit msgpack's 64-bit integers")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), _STR) + raw


# -- writing -------------------------------------------------------------------


class _Raw:
    """Bytes ``[start, stop)`` of a leaf's flat byte view (a 1-D uint8
    tensor on any device, or a 1-D uint8 numpy array)."""

    def __init__(self, view, start: int, stop: int):
        self.view, self.start, self.stop = view, start, stop


def _leaf_bytes(x) -> Tuple[str, Tuple[int, ...], Any, int]:
    """``(dtype name, shape, flat uint8 view, item size)`` of a tensor or
    an array."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _DTYPE_NAMES:
            raise TypeError(f"no msgpack dtype name for {x.dtype}")
        flat = x.detach().contiguous().reshape(-1)
        return _DTYPE_NAMES[x.dtype], tuple(x.shape), flat.view(torch.uint8), x.element_size()
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise TypeError("object and structured dtypes have no msgpack form")
    flat = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    return x.dtype.name, tuple(x.shape), flat, x.dtype.itemsize


def _array_ext(name: str, shape, view, start: int, stop: int, ext_type: int, out: List) -> None:
    """One array as flax's extension: the headers, then the raw bytes."""
    head = _sized(3, _ARRAY) + _sized(len(shape), _ARRAY) + b"".join(_int(d) for d in shape)
    head += _str(name) + _sized(stop - start, _BIN)
    out.append(_ext_header(len(head) + stop - start, ext_type) + head)
    out.append(_Raw(view, start, stop))


def _encode(obj, out: List, chunkable: bool) -> None:
    """Append ``obj``'s encoding to ``out`` as bytes and :class:`_Raw`
    pieces. ``chunkable``: every container above is a dict (where flax
    chunks large leaves)."""
    if isinstance(obj, np.generic):  # before float: np.float64 is one
        name, shape, view, _ = _leaf_bytes(np.asarray(obj))
        _array_ext(name, shape, view, 0, len(view), _EXT_NPSCALAR, out)
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        out.append(_str(obj))
    elif isinstance(obj, bytes):
        out.append(_sized(len(obj), _BIN) + obj)
    elif isinstance(obj, complex):
        payload = b"\x92\xcb" + struct.pack(">d", obj.real) + b"\xcb" + struct.pack(">d", obj.imag)
        out.append(_ext_header(len(payload), _EXT_COMPLEX) + payload)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), _MAP))
        for key in sorted(obj):
            if not isinstance(key, str):
                raise TypeError(f"dict keys must be str, not {type(key).__name__}")
            out.append(_str(key))
            _encode(obj[key], out, chunkable)
    elif isinstance(obj, list):
        out.append(_sized(len(obj), _ARRAY))
        for item in obj:
            _encode(item, out, False)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        name, shape, view, itemsize = _leaf_bytes(obj)
        nbytes = len(view)
        if not (chunkable and nbytes > MAX_CHUNK_SIZE):
            _array_ext(name, shape, view, 0, nbytes, _EXT_NDARRAY, out)
            return
        step = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
        starts = range(0, nbytes, step)
        out.append(_sized(3, _MAP) + _str(CHUNKED) + b"\xc3" + _str("shape") + _sized(len(shape), _MAP))
        for i, d in enumerate(shape):
            out.append(_str(str(i)) + _int(d))
        out.append(_str("chunks") + _sized(len(starts), _MAP))
        for i, a in enumerate(starts):
            b = min(a + step, nbytes)
            out.append(_str(str(i)))
            _array_ext(name, ((b - a) // itemsize,), view, a, b, _EXT_NDARRAY, out)
    else:
        raise TypeError(f"flax's msgpack format has no form for {type(obj).__name__}")


def _staging(count: int) -> List[torch.Tensor]:
    return [torch.empty(PIECE_BYTES, dtype=torch.uint8, pin_memory=True) for _ in range(count)]


def _timed(fn, buf) -> float:
    t0 = time.perf_counter()
    fn(buf)
    return time.perf_counter() - t0


def write(fileobj: BinaryIO, tree, timings: Optional[Dict[str, float]] = None) -> str:
    """Write ``tree`` (dicts with str keys, lists, None, bool, int, float,
    str, bytes, numpy scalars, and torch tensors on any device or numpy
    arrays as leaves) to ``fileobj`` in flax's msgpack format, byte for byte
    what ``flax.serialization.msgpack_serialize`` writes for the same tree
    as numpy arrays. Returns the sha256 (hex) of the bytes written.

    A device leaf is copied to the host a piece of ``PIECE_BYTES`` at a time
    through two pinned buffers; each piece is hashed and written by two
    threads while the next one is copied. With ``timings``, adds the busy
    seconds of the three under ``"d2h_s"``, ``"hash_s"`` and ``"write_s"``,
    and the bytes under ``"bytes"``."""
    segments: List = []
    _encode(tree, segments, True)
    sha = hashlib.sha256()
    hasher, writer = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    futures, staging = [], None
    in_use: Dict[int, list] = {}  # staging buffer -> the futures still reading it
    d2h_s, total, small = 0.0, 0, bytearray()

    def emit(buf) -> list:
        fs = [hasher.submit(_timed, sha.update, buf), writer.submit(_timed, fileobj.write, buf)]
        futures.extend(fs)
        return fs

    try:
        for seg in segments:
            if isinstance(seg, bytes):
                small += seg
                continue
            if small:
                emit(bytes(small))
                total += len(small)
                small = bytearray()
            total += seg.stop - seg.start
            for i, a in enumerate(range(seg.start, seg.stop, PIECE_BYTES)):
                b = min(a + PIECE_BYTES, seg.stop)
                if isinstance(seg.view, np.ndarray):
                    emit(memoryview(seg.view[a:b]))
                elif seg.view.device.type == "cpu":
                    emit(memoryview(seg.view[a:b].numpy()))
                else:
                    staging = staging or _staging(2)
                    slot = i % 2
                    for f in in_use.pop(slot, ()):
                        f.result()
                    t0 = time.perf_counter()
                    staging[slot][: b - a].copy_(seg.view[a:b])
                    d2h_s += time.perf_counter() - t0
                    in_use[slot] = emit(memoryview(staging[slot][: b - a].numpy()))
        if small:
            emit(bytes(small))
            total += len(small)
        busy = [f.result() for f in futures]
    finally:
        hasher.shutdown(wait=True)
        writer.shutdown(wait=True)
    if timings is not None:
        timings["d2h_s"] = timings.get("d2h_s", 0.0) + d2h_s
        timings["hash_s"] = timings.get("hash_s", 0.0) + sum(busy[0::2])
        timings["write_s"] = timings.get("write_s", 0.0) + sum(busy[1::2])
        timings["bytes"] = timings.get("bytes", 0) + total
    return sha.hexdigest()


# -- reading -------------------------------------------------------------------

_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LENGTHS = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT_LENGTHS = {v: k for k, v in _FIXEXT.items()}


class _Reader:
    """A msgpack parser over a file that hashes every byte it reads, in
    order, on one worker thread."""

    def __init__(self, fileobj: BinaryIO, device: torch.device):
        self.f = fileobj
        self.device = device
        self.sha = hashlib.sha256()
        self.hasher = ThreadPoolExecutor(1)
        self.futures: list = []
        self.buf = b""
        self.pos = 0
        self.offset = 0  # the file position of buf[0]
        self.read_s = 0.0
        self.staging = None
        self.events: Dict[int, Tuple[torch.cuda.Event, list]] = {}

    def _hash(self, data) -> list:
        f = self.hasher.submit(_timed, self.sha.update, data)
        self.futures.append(f)
        return [f]

    def _readinto(self, view: memoryview) -> None:
        t0 = time.perf_counter()
        done = 0
        while done < len(view):
            n = self.f.readinto(view[done:])
            if not n:
                raise ValueError("state.msgpack ends inside an object")
            done += n
        self.read_s += time.perf_counter() - t0

    def take(self, n: int) -> bytes:
        if len(self.buf) - self.pos < n:
            self.offset += self.pos
            self.buf, self.pos = self.buf[self.pos :], 0
            t0 = time.perf_counter()
            while len(self.buf) < n:
                more = self.f.read(max(n - len(self.buf), _READ_AHEAD))
                if not more:
                    raise ValueError("state.msgpack ends inside an object")
                self._hash(more)
                self.buf += more
            self.read_s += time.perf_counter() - t0
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def fill(self, dest: torch.Tensor) -> None:
        """Read ``dest.numel()`` bytes into the 1-D uint8 tensor ``dest``:
        what is buffered, then straight from the file (through pinned
        buffers for a device tensor)."""
        n = dest.numel()
        k = min(n, len(self.buf) - self.pos)
        if k:
            dest[:k].copy_(torch.frombuffer(bytearray(self.take(k)), dtype=torch.uint8))
        if k < n:  # the buffer is spent: the rest comes from the file
            self.offset += len(self.buf) + n - k
            self.buf, self.pos = b"", 0
        if dest.device.type == "cpu":
            host = dest.numpy()
            for a in range(k, n, PIECE_BYTES):
                view = memoryview(host[a : min(a + PIECE_BYTES, n)])
                self._readinto(view)
                self._hash(view)
            return
        self.staging = self.staging or _staging(2)
        for i, a in enumerate(range(k, n, PIECE_BYTES)):
            b = min(a + PIECE_BYTES, n)
            slot = i % 2
            if slot in self.events:
                event, fs = self.events.pop(slot)
                event.synchronize()
                for f in fs:
                    f.result()
            piece = self.staging[slot][: b - a]
            view = memoryview(piece.numpy())
            self._readinto(view)
            fs = self._hash(view)
            dest[a:b].copy_(piece, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self.events[slot] = (event, fs)

    def finish(self) -> Tuple[str, float]:
        """Check that the file ends here; the sha256 (hex) of all of it and
        the hashing thread's busy seconds."""
        if self.pos != len(self.buf) or self.f.read(1):
            raise ValueError("state.msgpack has bytes after its object")
        for event, _ in self.events.values():
            event.synchronize()
        busy = sum(f.result() for f in self.futures)
        return self.sha.hexdigest(), busy

    # -- objects --

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code <= 0x8F:
            return self.map(code & 0x0F)
        if code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if code <= 0xBF:
            return self.take(code & 0x1F).decode("utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if code in _FIXEXT_LENGTHS:
            return self.ext(_FIXEXT_LENGTHS[code], self.take(1)[0])
        if code not in _LENGTHS:
            raise ValueError(f"byte 0x{code:02x} starts no msgpack object")
        kind, fmt = _LENGTHS[code]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n, self.take(1)[0])

    def map(self, n: int):
        out = {}
        for i in range(n):
            key = self.value()
            if i == 0 and key == CHUNKED:
                return self.chunked(n)
            out[key] = self.value()
        return out

    def map_len(self) -> int:
        code = self.take(1)[0]
        if 0x80 <= code <= 0x8F:
            return code & 0x0F
        if code in (0xDE, 0xDF):
            return self.unpack(_LENGTHS[code][1])
        raise ValueError("a chunked array's chunks are not a map")

    def ext(self, n: int, ext_type: int):
        if ext_type == _EXT_COMPLEX:
            start = self.tell()
            real, imag = self.value()
            if self.tell() - start != n:
                raise ValueError("a complex extension does not hold [real, imag]")
            return complex(real, imag)
        if ext_type not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {ext_type}")
        dtype, shape, nbytes = self.array_header(n)
        dest = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        self.fill(dest)
        return dest.view(dtype).reshape(shape)

    def array_header(self, n: int) -> Tuple[torch.dtype, Tuple[int, ...], int]:
        """Parse an array extension's payload up to its raw bytes, which
        follow: ``(dtype, shape, byte count)``."""
        start = self.tell()
        if self.take(1)[0] != 0x93:
            raise ValueError("an array extension does not hold [shape, dtype, bytes]")
        shape, name = tuple(self.value()), self.value()
        if name not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {name!r} in state.msgpack")
        code = self.take(1)[0]
        if code not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an array extension's data is not bin")
        nbytes = self.unpack(_LENGTHS[code][1])
        dtype = _TORCH_DTYPES[name]
        if nbytes != math.prod(shape) * dtype.itemsize or self.tell() - start + nbytes != n:
            raise ValueError(f"an array of shape {shape} and dtype {name} holds {nbytes} bytes")
        return dtype, shape, nbytes

    def tell(self) -> int:
        """Bytes of the file parsed so far."""
        return self.offset + self.pos

    def chunked(self, n: int) -> torch.Tensor:
        """flax's chunked array, its chunks read into one tensor in place."""
        if n != 3 or self.value() is not True or self.value() != "shape":
            raise ValueError("a chunked array does not follow flax's layout")
        dims = self.value()
        shape = tuple(dims[str(i)] for i in range(len(dims)))
        if self.value() != "chunks":
            raise ValueError("a chunked array does not follow flax's layout")
        dest, dtype, offset = None, None, 0
        for i in range(self.map_len()):
            if self.value() != str(i):
                raise ValueError("a chunked array's chunks are out of order")
            code = self.take(1)[0]
            if code not in (0xC7, 0xC8, 0xC9):
                raise ValueError("a chunk is not an array extension")
            length = self.unpack(_LENGTHS[code][1])
            if self.take(1)[0] != _EXT_NDARRAY:
                raise ValueError("a chunk is not an array extension")
            chunk_dtype, _, nbytes = self.array_header(length)
            if dest is None:
                dtype = chunk_dtype
                dest = torch.empty(math.prod(shape) * dtype.itemsize, dtype=torch.uint8, device=self.device)
            if chunk_dtype != dtype or offset + nbytes > dest.numel():
                raise ValueError("a chunked array's chunks do not match its shape")
            self.fill(dest[offset : offset + nbytes])
            offset += nbytes
        if dest is None or offset != dest.numel():
            raise ValueError("a chunked array's chunks do not fill its shape")
        return dest.view(dtype).reshape(shape)


def read(path, device: "torch.device | str" = "cpu", timings: Optional[Dict[str, float]] = None):
    """Parse the flax msgpack file at ``path``: ``(tree, sha256 hex of the
    file)``. Dicts, lists and scalars come back as Python objects, array
    leaves as torch tensors on ``device`` (flax's chunked arrays joined, in
    place), bfloat16 ones as ``torch.bfloat16``. The file is read once,
    hashed as it is read; a device's leaves go through two pinned buffers.
    With ``timings``, adds the seconds spent reading the file and hashing
    it under ``"read_s"`` and ``"hash_s"``."""
    device = torch.device(device)
    with open(path, "rb", buffering=0) as f:
        reader = _Reader(f, device)
        try:
            tree = reader.value()
            digest, hash_s = reader.finish()
        finally:
            reader.hasher.shutdown(wait=True)
    if timings is not None:
        timings["read_s"] = timings.get("read_s", 0.0) + reader.read_s
        timings["hash_s"] = timings.get("hash_s", 0.0) + hash_s
    return tree, digest
