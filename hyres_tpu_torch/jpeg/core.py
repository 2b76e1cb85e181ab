"""JPEG transform path in PyTorch: color, 4:2:0, blockwise DCT + quant.

Counterpart of ``hyres_tpu/jpeg/core.py`` (inference half). Layouts
follow the reference: NHWC images in [0, 1], planes (B, H, W) in
[0, 255], coefficient planes (B, nh, nw, 8, 8) int32. The blockwise
DCT goes through ``kernels/dct.py``: CUDA kernels K1/K2 for CUDA
tensors, one launch for the three planes of a request each way, their
plain versions for CPU tensors. Quant tables stay host values, so the
path neither copies to the card nor synchronises. The whole path stays
in float32 whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import dct
from . import tables as T


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


def decode_from_coefficients(cy: torch.Tensor, ccb: torch.Tensor, ccr: torch.Tensor,
                             quality: int, height: int, width: int) -> torch.Tensor:
    """Quantized 4:2:0 planes at ``quality`` -> NHWC [0,1] reconstruction."""
    qy, qc = T.quality_to_qtables(quality)
    return decode_with_qtables(cy, ccb, ccr, qy, qc, height, width)
