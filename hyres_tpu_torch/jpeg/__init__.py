"""The JPEG base layer: transforms on the device (K1/K2), JFIF bytes on
the host.

``JpegCodec`` is the counterpart of ``hyres_tpu/jpeg/__init__.py:28-61``:
``codec(x)`` gives (decoded, mean bpp) on the device with the exact scan
rate (one K1 and one K2 launch on a card), ``compress`` real JFIF byte
buffers (one K1 launch and one pull for the batch), ``decompress`` the
batch back (``decode_jfif``: the streams that share their quant tables
go up as one dense byte plane and through one K2 launch).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import core, tables
from .bitstream import ParsedJpeg, assemble_batch, assemble_jfif, check_420, coef_bytes
from .core import (JpegCoefficients, coefs_from_bytes, decode_from_coefficients,
                   decode_with_qtables, encode_to_coefficients, jpeg_roundtrip,
                   scan_bits)


@torch.no_grad()
def decode_jfif(buffers: List[bytes], device) -> torch.Tensor:
    """Baseline 3-component 4:2:0 JFIF buffers of one size -> NHWC [0, 1]
    batch on ``device``, in the buffers' order. Each group of streams with
    the same quant tables takes one upload and one K2 launch; any other
    stream raises ValueError."""
    planes = [ParsedJpeg(b) for b in buffers]
    check_420(planes)
    groups: dict = {}
    for i, p in enumerate(planes):
        groups.setdefault((p.qtables[0].tobytes(), p.qtables[1].tobytes()), []).append(i)
    out: List[torch.Tensor] = [None] * len(planes)
    for idx in groups.values():
        group = [planes[i] for i in idx]
        coef_u8, dtype, shapes = coef_bytes(group)
        coefs = coefs_from_bytes(torch.from_numpy(coef_u8).to(device), dtype, shapes)
        p0 = group[0]
        dec = decode_with_qtables(*coefs, p0.qtables[0], p0.qtables[1], p0.height, p0.width)
        for j, i in enumerate(idx):
            out[i] = dec[j]
    return torch.stack(out)


class JpegCodec:
    """Batched JPEG base layer at one quality, on ``device`` (the card by
    default; ``"cpu"`` runs the kernels' plain versions)."""

    def __init__(self, quality: int = 1, device="cuda"):
        from ..utils.device import resolve_device

        self.quality = int(quality)
        self.device = resolve_device(device)

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC [0, 1] -> (decoded, the batch's mean bpp), no gradient."""
        decoded, bpp = jpeg_roundtrip(x.to(self.device, torch.float32), self.quality)
        return decoded, torch.mean(bpp)

    @torch.no_grad()
    def compress(self, x: torch.Tensor) -> List[bytes]:
        """NHWC [0, 1] -> one baseline JFIF byte buffer an image."""
        c = encode_to_coefficients(x.to(self.device, torch.float32), self.quality)
        planes = (c.y, c.cb, c.cr)
        flat = torch.cat([p.reshape(p.shape[0], -1) for p in planes], dim=1)
        vals = flat.to(torch.int16).cpu().numpy()  # the one pull; |coef| <= 1023
        return assemble_batch(vals, [tuple(p.shape[1:]) for p in planes], c.width,
                              c.height, self.quality)

    def decompress(self, buffers: List[bytes]) -> torch.Tensor:
        """JFIF byte buffers (all one size) -> NHWC [0, 1] batch."""
        return decode_jfif(buffers, self.device)


__all__ = ["JpegCodec", "JpegCoefficients", "ParsedJpeg", "assemble_jfif", "core",
           "decode_from_coefficients", "decode_jfif", "decode_with_qtables",
           "encode_to_coefficients", "jpeg_roundtrip", "scan_bits", "tables"]
