"""Host JFIF bitstream assembly and parsing (ctypes over the coding lib).

Counterpart of ``hyres_tpu/jpeg/bitstream.py``: ``assemble_jfif`` turns
quantized 4:2:0 coefficient planes into baseline JFIF bytes
(``assemble_batch``: one buffer for each image of a batch) and
``ParsedJpeg`` reads coefficients and quant tables back; ``coef_bytes``
packs the parsed planes of same-size streams into one dense byte plane
for a single upload. Only the serial Huffman bit-twiddling runs here; the
transform math is ``jpeg/core.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np

from ..coding import build
from . import tables as T

_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    lib.hyj_encode_420.argtypes = [
        _I16P, _I16P, _I16P,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _I32P, _I32P, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.hyj_encode_420.restype = ctypes.c_int64
    lib.hyj_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.hyj_dec_new.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.hyj_dec_new.restype = ctypes.c_void_p
    lib.hyj_dec_free.argtypes = [ctypes.c_void_p]
    lib.hyj_dec_info.argtypes = [ctypes.c_void_p, _I32P]
    lib.hyj_dec_coeffs.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I16P]
    lib.hyj_dec_qtable.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P]
    return lib


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(_I16P)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def assemble_jfif(y_coef: np.ndarray, cb_coef: np.ndarray, cr_coef: np.ndarray,
                  width: int, height: int, quality: int) -> bytes:
    """Coefficient planes (nh, nw, 8, 8) int -> baseline JFIF bytes."""
    mh, mw = cb_coef.shape[0], cb_coef.shape[1]
    if y_coef.shape[:2] != (2 * mh, 2 * mw) or cr_coef.shape[:2] != (mh, mw):
        raise ValueError("planes are not 4:2:0 of one image")
    qy, qc = T.quality_to_qtables(quality)
    y = np.ascontiguousarray(np.asarray(y_coef).reshape(mh * 2, mw * 2, 64), np.int16)
    cb = np.ascontiguousarray(np.asarray(cb_coef).reshape(mh, mw, 64), np.int16)
    cr = np.ascontiguousarray(np.asarray(cr_coef).reshape(mh, mw, 64), np.int16)
    qy, qc = np.ascontiguousarray(qy), np.ascontiguousarray(qc)
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.hyj_encode_420(_i16p(y), _i16p(cb), _i16p(cr), width, height,
                           mw, mh, _i32p(qy), _i32p(qc), ctypes.byref(out))
    data = ctypes.string_at(out, n)
    lib.hyj_buf_free(out)
    return data


def assemble_batch(vals: np.ndarray, shapes: Sequence[tuple], width: int, height: int,
                   quality: int) -> List[bytes]:
    """(B, n) coefficients of a batch, the y, cb and cr planes flattened
    side by side with per-image ``shapes`` -> one JFIF buffer an image."""
    splits = np.cumsum([int(np.prod(s)) for s in shapes[:2]])
    y, cb, cr = (part.reshape((-1,) + tuple(s)) for part, s in
                 zip(np.split(vals, splits, axis=1), shapes))
    return [assemble_jfif(y[i], cb[i], cr[i], width, height, quality)
            for i in range(y.shape[0])]


class ParsedJpeg:
    """Coefficient-level parse of a baseline JFIF stream."""

    def __init__(self, data: bytes):
        lib = _lib()
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        h = lib.hyj_dec_new(buf, len(data))
        if not h:
            raise ValueError("unsupported or corrupt JPEG stream")
        try:
            info = np.zeros(11, np.int32)
            lib.hyj_dec_info(h, _i32p(info))
            self.width, self.height, self.ncomp = (int(v) for v in info[:3])
            self.mcu_w, self.mcu_h = int(info[3]), int(info[4])
            self.sampling = [(int(info[5 + 2 * c]), int(info[6 + 2 * c]))
                             for c in range(self.ncomp)]
            self.coeffs = []
            self.qtables = []
            for c in range(self.ncomp):
                hh, vv = self.sampling[c]
                bw, bh = self.mcu_w * hh, self.mcu_h * vv
                out = np.zeros((bh, bw, 64), np.int16)
                lib.hyj_dec_coeffs(h, c, _i16p(out))
                self.coeffs.append(out.reshape(bh, bw, 8, 8).astype(np.int32))
                q = np.zeros(64, np.int32)
                lib.hyj_dec_qtable(h, c, _i32p(q))
                self.qtables.append(q)
        finally:
            lib.hyj_dec_free(h)


def check_420(planes: Sequence[ParsedJpeg]) -> None:
    """Raise ValueError unless every stream is 3-component 4:2:0."""
    for p in planes:
        if p.ncomp != 3 or p.sampling[0] != (2, 2):
            raise ValueError("only 3-component 4:2:0 streams are supported")


def coef_bytes(planes: Sequence[ParsedJpeg]) -> Tuple[np.ndarray, np.dtype, List[tuple]]:
    """Parsed streams of one size -> ((B, n) uint8 dense coefficient bytes,
    their dtype (int8 when every value fits, else int16), the
    per-component plane shapes)."""
    stacked = [np.stack([p.coeffs[k] for p in planes]) for k in range(3)]
    flat = np.concatenate([c.reshape(len(planes), -1) for c in stacked], axis=1)
    flat = flat.astype(np.int8 if np.abs(flat).max() <= 127 else np.int16)
    return flat.view(np.uint8), flat.dtype, [c.shape[1:] for c in stacked]
