"""PNG reader for 8-bit RGB, non-interlaced images (zlib + numpy).

A frozen copy of the reader in ``hyres_tpu_torch/utils/png.py``, so that
the benchmark reads its photo the same way whatever a later change does to
the program. The card's machine has no PIL.
"""

from __future__ import annotations

import functools
import hashlib
import os

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for i in range(height):
        ftype, line = rows[i, 0], rows[i, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum of each channel along the row
            pix = line.reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(pix, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_sequential(ftype, line, prior, bpp)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[i] = cur
        prior = cur
    return out


def _unfilter_sequential(ftype: int, line: np.ndarray, prior: np.ndarray,
                         bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for j in range(len(cur)):
        a = cur[j - bpp] if j >= bpp else 0
        b = up[j]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[j - bpp] if j >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[j] = (cur[j] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB non-interlaced PNG."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are "
                         f"supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * 3 + 1):
        raise ValueError(f"{path}: PNG image data has the wrong size")
    return _unfilter(raw, height, width * 3, 3).reshape(height, width, 3)


def load_image(path) -> np.ndarray:
    """(1, H, W, 3) float32 in [0, 1], the layout the codecs take."""
    return read_png(path).astype(np.float32)[None] / 255.0


CACHE = Path(__file__).resolve().parents[2] / ".portbench_cache" / "photos"


@functools.lru_cache(maxsize=4)
def load_photo(path) -> np.ndarray:
    """``load_image`` of ``path``, read-only, once a process; the decoded
    pixels are kept beside the checkout (``.portbench_cache/photos/``, keyed
    by a hash of the file), since the row filters decode in Python."""
    data = Path(path).read_bytes()
    cached = CACHE / f"{Path(path).stem}-{hashlib.sha256(data).hexdigest()[:16]}.npy"
    try:
        x = np.load(cached)
    except (OSError, ValueError):
        x = load_image(path)
        CACHE.mkdir(parents=True, exist_ok=True)
        tmp = cached.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.save(f, x)
        os.replace(tmp, cached)
    x.setflags(write=False)
    return x
