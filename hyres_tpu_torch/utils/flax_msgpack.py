"""Reader and writer for flax msgpack checkpoints, in the standard
library + numpy.

Counterpart of ``hyres_tpu/train/checkpoint.py`` for machines without
flax or msgpack. Covers what flax's ``msgpack_serialize`` writes for a
tree of arrays: maps, arrays, str, bin, ints, floats, nil/bools, and
flax's ext types 1 (ndarray: a packed ``(shape, dtype name, raw bytes)``
triple) and 3 (a numpy scalar in the same form). ``packb`` picks the
smallest encoding of each value, as the ``msgpack`` package does, so its
bytes equal ``msgpack.packb(obj, use_bin_type=True)`` and, for a tree of
arrays, flax's ``msgpack_serialize``.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack marker 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = unpackb(payload)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (flax ndarray ext types as numpy)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_checkpoint(path) -> dict:
    """The raw dict-of-dicts of a flax msgpack file, arrays as numpy."""
    return unpackb(Path(path).read_bytes())


def load_artifact(path) -> Tuple[dict, dict, dict]:
    """A deployment artifact -> (config, params, tables).

    ``config`` holds ints (N, M, jpeg_quality); ``params`` the
    ``residual_model`` and ``refine`` trees; ``tables`` the baked
    ``gaussian`` and ``bottleneck`` CDFs. All leaves are numpy arrays.
    """
    raw = load_checkpoint(path)
    config = {k: int(v) for k, v in raw["config"].items()}
    return config, raw["params"], raw["tables"]


# -- writer ------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              markers: tuple) -> None:
    """Append a length header: a fix marker (fix | n) when n <= fix_max,
    else the smallest of the 8-, 16- and 32-bit forms in ``markers``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for marker, fmt, limit in zip(markers, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if marker is not None and n <= limit:
            out.append(marker)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for marker, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= limit:
                out.append(marker)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for marker, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                   (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -limit:
                out.append(marker)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} to msgpack")


def packb(obj: Any) -> bytes:
    """Encode one object: maps, lists and tuples (as arrays), str, bytes
    (as bin), ints, floats (as float64), None, bools, numpy arrays (flax
    ext type 1) and numpy scalars (ext type 3)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _sorted_tree(node):
    """Maps with their keys sorted, at every depth: the order flax's
    ``msgpack_serialize`` writes (it rebuilds the tree as a JAX pytree)."""
    if isinstance(node, dict):
        return {k: _sorted_tree(node[k]) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return [_sorted_tree(v) for v in node]
    return node


def save_checkpoint(tree: dict, path) -> None:
    """Write ``tree`` as flax's ``msgpack_serialize`` does (keys sorted at
    every depth) to ``path``, through a ``.tmp`` file and an atomic rename
    as ``hyres_tpu/train/checkpoint.py:33`` does."""
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(_sorted_tree(tree)))
    os.replace(tmp, path)
