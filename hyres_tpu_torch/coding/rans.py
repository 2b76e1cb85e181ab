"""ctypes bindings for the host C++ rANS coder.

Counterpart of ``hyres_tpu/coding/rans.py:65-159``: ``BufferedRansEncoder``
(``encode_with_indexes``/``flush``), the one-shot ``RansEncoder``,
``RansLut`` (O(1) symbol lookup per CDF row) and ``RansDecoder``
(``set_stream``/``decode_stream``, and the one-shot
``decode_with_indexes``). The library is built and loaded on first use,
not at import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import build

_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    lib.hyc_enc_new.restype = ctypes.c_void_p
    lib.hyc_enc_free.argtypes = [ctypes.c_void_p]
    lib.hyc_enc_push.argtypes = [
        ctypes.c_void_p, _I32P, _I32P, ctypes.c_int64,
        _I32P, ctypes.c_int32, _I32P, _I32P,
    ]
    lib.hyc_enc_flush.argtypes = [ctypes.c_void_p]
    lib.hyc_enc_flush.restype = ctypes.c_int64
    lib.hyc_enc_data.argtypes = [ctypes.c_void_p]
    lib.hyc_enc_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.hyc_dec_new.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.hyc_dec_new.restype = ctypes.c_void_p
    lib.hyc_dec_free.argtypes = [ctypes.c_void_p]
    lib.hyc_dec_stream.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int64,
        _I32P, ctypes.c_int32, _I32P, _I32P, _I32P,
    ]
    lib.hyc_lut_new.argtypes = [_I32P, ctypes.c_int32, _I32P, ctypes.c_int32]
    lib.hyc_lut_new.restype = ctypes.c_void_p
    lib.hyc_lut_free.argtypes = [ctypes.c_void_p]
    lib.hyc_dec_stream_lut.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, _I32P, ctypes.c_int64,
        _I32P, ctypes.c_int32, _I32P, _I32P, _I32P,
    ]
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


class BufferedRansEncoder:
    """Accumulates symbols; ``flush`` emits them LIFO as one rANS stream."""

    def __init__(self):
        self._h = _lib().hyc_enc_new()

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().hyc_enc_free(self._h)
            self._h = None

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths, offsets):
        symbols = _i32(symbols).ravel()
        indexes = _i32(indexes).ravel()
        if symbols.size != indexes.size:
            raise ValueError("symbols and indexes differ in size")
        cdfs = _i32(cdfs)
        if cdfs.ndim != 2:
            raise ValueError("cdfs must be a (rows, max_len) table")
        lengths, offs = _i32(cdf_lengths), _i32(offsets)
        _lib().hyc_enc_push(self._h, _ptr(symbols), _ptr(indexes), symbols.size,
                            _ptr(cdfs), cdfs.shape[1], _ptr(lengths), _ptr(offs))

    def flush(self) -> bytes:
        n = _lib().hyc_enc_flush(self._h)
        return ctypes.string_at(_lib().hyc_enc_data(self._h), n)


class RansEncoder:
    """One-shot encode (CompressAI ``RansEncoder.encode_with_indexes``)."""

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes:
        enc = BufferedRansEncoder()
        enc.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets)
        return enc.flush()


class RansLut:
    """Per-table O(1) symbol lookup (2^16 uint16 entries per CDF row).

    Built once per baked table set and reused across decodes; keeps the
    owning arrays alive so the C side can read the CDF rows.
    """

    def __init__(self, cdfs, cdf_lengths):
        self.cdfs = _i32(cdfs)
        self.cdf_lengths = _i32(cdf_lengths)
        self._h = _lib().hyc_lut_new(_ptr(self.cdfs), self.cdfs.shape[1],
                                     _ptr(self.cdf_lengths), self.cdfs.shape[0])

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().hyc_lut_free(self._h)
            self._h = None


class RansDecoder:
    def __init__(self, data: bytes | None = None):
        self._h = None
        if data is not None:
            self.set_stream(data)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().hyc_dec_free(self._h)
            self._h = None

    def set_stream(self, data: bytes):
        if self._h:
            _lib().hyc_dec_free(self._h)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._h = _lib().hyc_dec_new(buf, len(data))

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets,
                      lut: RansLut | None = None) -> np.ndarray:
        indexes = _i32(indexes)
        flat = indexes.ravel()
        cdfs = _i32(cdfs)
        lengths, offs = _i32(cdf_lengths), _i32(offsets)
        out = np.empty(flat.size, np.int32)
        if lut is not None:
            _lib().hyc_dec_stream_lut(
                self._h, lut._h, _ptr(flat), flat.size, _ptr(cdfs),
                cdfs.shape[1], _ptr(lengths), _ptr(offs), _ptr(out))
        else:
            _lib().hyc_dec_stream(
                self._h, _ptr(flat), flat.size, _ptr(cdfs), cdfs.shape[1],
                _ptr(lengths), _ptr(offs), _ptr(out))
        return out.reshape(indexes.shape)

    def decode_with_indexes(self, data: bytes, indexes, cdfs, cdf_lengths,
                            offsets) -> np.ndarray:
        """One-shot decode of ``data`` (CompressAI ``RansDecoder``)."""
        self.set_stream(data)
        return self.decode_stream(indexes, cdfs, cdf_lengths, offsets)
