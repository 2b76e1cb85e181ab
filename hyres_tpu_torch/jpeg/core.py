"""JPEG transform path in PyTorch: color, 4:2:0, blockwise DCT + quant,
the exact Huffman rate and the training roundtrip.

Counterpart of ``hyres_tpu/jpeg/core.py``. Layouts
follow the reference: NHWC images in [0, 1], planes (B, H, W) in
[0, 255], coefficient planes (B, nh, nw, 8, 8) int32. The blockwise
DCT goes through ``kernels/dct.py``: CUDA kernels K1/K2 for CUDA
tensors, one launch for the three planes of a request each way, their
plain versions for CPU tensors. Quant tables stay host values, so the
path neither copies to the card nor synchronises. The whole path stays
in float32 whatever the model's compute dtype.

The exact baseline Huffman bit count of a scan (``scan_bits``, the
reference's ``_dc_bits``/``_ac_bits``, ``:147-180``) is computed on the
device from the coefficient planes, in integer arithmetic; only the
training roundtrip ``jpeg_roundtrip`` (``:270-285``) calls it, so the
serving encode does no rate work.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import dct
from . import tables as T


def dct_matrix(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Orthonormal 8x8 DCT-II matrix scaled per JPEG, D[u, x]: the factor
    of the Kronecker matrix that K1/K2 apply (``kernels/dct.py KRON``)."""
    return torch.as_tensor(dct.dct8(), dtype=dtype, device=device)


def rgb_to_ycbcr(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NHWC RGB in [0,1] -> integer-rounded Y, Cb, Cr planes in [0,255]."""
    r, g, b = x[..., 0] * 255.0, x[..., 1] * 255.0, x[..., 2] * 255.0
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return tuple(torch.clamp(torch.round(p), 0.0, 255.0) for p in (y, cb, cr))


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0) / 255.0


def downsample_420(p: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/2, W/2): 2x2 mean, rounded (libjpeg h2v2 box)."""
    B, H, W = p.shape
    return torch.round(p.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4)))


def _up1d(a: torch.Tensor) -> torch.Tensor:
    """Doubles the last axis with the 3:1 triangle stencil, edge clamped."""
    left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    even = (3.0 * a + left) * 0.25
    odd = (3.0 * a + right) * 0.25
    return torch.stack([even, odd], dim=-1).reshape(*a.shape[:-1], -1)


def upsample_420(p: torch.Tensor) -> torch.Tensor:
    """(B, h, w) -> (B, 2h, 2w) triangle ("fancy") upsampling."""
    p = _up1d(p)
    return _up1d(p.transpose(-1, -2)).transpose(-1, -2)


def pad_to_multiple(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Edge-pad NHWC H and W up to multiples of ``mult`` (the reference's
    ``_pad_to`` here and ``models/codec.py pad_to_multiple``)."""
    ph, pw = (-x.shape[1]) % mult, (-x.shape[2]) % mult
    if not (ph or pw):
        return x
    x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
    return x.permute(0, 2, 3, 1).contiguous()


def fdct_quant(plane: torch.Tensor, qtbl) -> torch.Tensor:
    """Plane [0,255] (B, H, W) -> quantized coefficients (B, nh, nw, 8, 8)
    int32, through K1. ``qtbl``: a host quant table."""
    return dct.fdct_quant_planes([plane.to(torch.float32)], [qtbl])[0]


def dequant_idct(coef: torch.Tensor, qtbl) -> torch.Tensor:
    """Quantized coefficients (B, nh, nw, 8, 8) int8/int16/int32 -> plane
    in [0,255], through K2. ``qtbl``: a host quant table."""
    return dct.dequant_idct_planes([coef], [qtbl])[0]


class JpegCoefficients(NamedTuple):
    """Quantized 4:2:0 coefficient planes of a batch."""

    y: torch.Tensor    # (B, nh_y, nw_y, 8, 8) int32
    cb: torch.Tensor   # (B, nh_c, nw_c, 8, 8)
    cr: torch.Tensor
    height: int        # original image dims (pre-padding)
    width: int


def encode_to_coefficients(x: torch.Tensor, quality: int) -> JpegCoefficients:
    """NHWC [0,1] -> quantized 4:2:0 coefficient planes."""
    H, W = x.shape[1], x.shape[2]
    x = pad_to_multiple(x.to(torch.float32), 16)
    qy, qc = T.quality_to_qtables(quality)
    y, cb, cr = rgb_to_ycbcr(x)
    cb = downsample_420(cb)
    cr = downsample_420(cr)
    cy, ccb, ccr = dct.fdct_quant_planes([y, cb, cr], [qy, qc, qc])
    return JpegCoefficients(cy, ccb, ccr, H, W)


def decode_with_qtables(cy: torch.Tensor, ccb: torch.Tensor, ccr: torch.Tensor,
                        qy, qc, height: int, width: int) -> torch.Tensor:
    """Quantized 4:2:0 planes (int8, int16 or int32, one dtype) + explicit
    host quant tables -> NHWC [0,1]."""
    y, cb, cr = dct.dequant_idct_planes([cy, ccb, ccr], [qy, qc, qc])
    return ycbcr_to_rgb(y, upsample_420(cb), upsample_420(cr))[:, :height, :width, :]


def coefs_from_bytes(d_u8: torch.Tensor, dtype: np.dtype, shapes,
                     sparse_cap: int | None = None) -> list:
    """(B, n) uint8 bytes of ``bitstream.coef_bytes`` (on any device) ->
    [y, cb, cr] (B, nh, nw, 8, 8) planes of ``dtype``, views of them.

    With ``sparse_cap`` the bytes are instead the sparse layout
    [pos int32 * cap][val int16 * cap] (positions padded with n), and the
    pairs scatter on the device into int16 planes with no host read: the
    padding lands in slot n of an (n + 8)-wide buffer (8 dropped slots
    keep each image's row 16-byte aligned for K2)."""
    B = d_u8.shape[0]
    sizes = [int(np.prod(s)) for s in shapes]
    if sparse_cap is None:
        flat = d_u8.contiguous().view(torch.int8 if dtype == np.int8 else torch.int16)
    else:
        n = sum(sizes)
        pos = d_u8[:, :4 * sparse_cap].contiguous().view(torch.int32)
        val = d_u8[:, 4 * sparse_cap:6 * sparse_cap].contiguous().view(torch.int16)
        flat = torch.zeros((B, n + 8), dtype=torch.int16, device=d_u8.device)
        flat.scatter_(1, pos.long(), val)
        flat = flat[:, :n]
    return [part.reshape(B, *shp) for part, shp in
            zip(torch.split(flat, sizes, dim=1), shapes)]


def decode_from_coefficients(cy: torch.Tensor, ccb: torch.Tensor, ccr: torch.Tensor,
                             quality: int, height: int, width: int) -> torch.Tensor:
    """Quantized 4:2:0 planes at ``quality`` -> NHWC [0,1] reconstruction."""
    qy, qc = T.quality_to_qtables(quality)
    return decode_with_qtables(cy, ccb, ccr, qy, qc, height, width)


# -- exact Huffman rate (training) --------------------------------------------

_NBITS_MAX = 2047  # |DC difference| <= 2 * 1023


@functools.lru_cache(maxsize=None)
def _rate_tables(device: torch.device) -> dict:
    """The lookup tables of the rate, uploaded once a process and device:
    the magnitude category of |v| <= 2047, the zigzag order and the four
    Huffman code-length tables."""
    nbits = np.array([int(v).bit_length() for v in range(_NBITS_MAX + 1)], np.int64)
    host = {"nbits": nbits, "zigzag": T.ZIGZAG.astype(np.int64),
            "dcl": T.DC_LUMA_LEN, "dcc": T.DC_CHROMA_LEN,
            "acl": T.AC_LUMA_LEN, "acc": T.AC_CHROMA_LEN}
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device) for k, v in host.items()}


def _nbits(v: torch.Tensor, tabs: dict) -> torch.Tensor:
    """JPEG magnitude category: the number of bits of |v|, by an exact
    integer lookup (int64). Coefficients of finite pixels stay inside the
    table; the clamp keeps the lookup in range for non-finite ones (a
    batch the train step's NaN guard then skips)."""
    return tabs["nbits"][v.long().abs().clamp(0, _NBITS_MAX)]


def _dc_bits(dc_seq: torch.Tensor, dc_len: torch.Tensor, tabs: dict) -> torch.Tensor:
    """dc_seq: (B, N) DC values in scan order -> DC bits an image."""
    prev = torch.cat([torch.zeros_like(dc_seq[:, :1]), dc_seq[:, :-1]], dim=1)
    s = _nbits(dc_seq - prev, tabs)
    return torch.sum(dc_len[s] + s, dim=1)


def _ac_bits(zz: torch.Tensor, ac_len: torch.Tensor, tabs: dict) -> torch.Tensor:
    """zz: (B, N, 64) zigzag-ordered coefficients -> AC bits an image. The
    zero run before each nonzero comes from a cummax over positions."""
    v = zz[..., 1:]
    nz = v != 0
    idx = torch.arange(1, 64, dtype=torch.int64, device=v.device)
    marked = torch.where(nz, idx, 0)
    last_incl = torch.cummax(marked, dim=-1).values
    last_excl = torch.cat([torch.zeros_like(last_incl[..., :1]), last_incl[..., :-1]], dim=-1)
    run = idx - last_excl - 1
    s = _nbits(v, tabs)
    code = ac_len[(run % 16) * 16 + s] + s + (run // 16) * ac_len[0xF0]
    bits = torch.sum(torch.where(nz, code, 0), dim=-1)
    eob = torch.where(last_incl[..., -1] < 63, ac_len[0], 0)
    return torch.sum(bits + eob, dim=1)


def scan_bits(c: JpegCoefficients) -> torch.Tensor:
    """(B,) int64: the exact entropy-coded bit count of each image's
    baseline scan (standard Huffman tables, MCU order, 4:2:0)."""
    tabs = _rate_tables(c.y.device)
    B, nh, nw = c.y.shape[:3]
    mh, mw = nh // 2, nw // 2
    # luma blocks in MCU scan order: (my, mx, by, bx)
    y_seq = (c.y.reshape(B, mh, 2, mw, 2, 8, 8).permute(0, 1, 3, 2, 4, 5, 6)
             .reshape(B, mh * mw * 4, 64))
    cb_seq = c.cb.reshape(B, mh * mw, 64)
    cr_seq = c.cr.reshape(B, mh * mw, 64)
    zz = tabs["zigzag"]
    return (_dc_bits(y_seq[..., 0], tabs["dcl"], tabs)
            + _dc_bits(cb_seq[..., 0], tabs["dcc"], tabs)
            + _dc_bits(cr_seq[..., 0], tabs["dcc"], tabs)
            + _ac_bits(y_seq[..., zz], tabs["acl"], tabs)
            + _ac_bits(cb_seq[..., zz], tabs["acc"], tabs)
            + _ac_bits(cr_seq[..., zz], tabs["acc"], tabs))


@torch.no_grad()
def jpeg_roundtrip(x: torch.Tensor, quality: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JPEG encode + decode of an NHWC [0,1] batch on its device, with no
    gradient: one K1 and one K2 launch on a card. Returns (decoded NHWC
    [0,1], bpp (B,) float32), the bpp counting the exact scan bits padded
    to a byte plus the fixed JFIF header."""
    H, W = x.shape[1], x.shape[2]
    c = encode_to_coefficients(x, quality)
    dec = decode_from_coefficients(c.y, c.cb, c.cr, quality, H, W)
    bits = scan_bits(c).to(torch.float32)
    total_bits = 8.0 * torch.ceil(bits / 8.0) + 8.0 * T.HEADER_BYTES
    return dec, total_bits / (H * W)
