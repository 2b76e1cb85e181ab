"""JPEG through PIL/libjpeg (counterpart of ``hyres_tpu/jpeg/pil.py``).

The reference's second JPEG backend: real libjpeg bytes and a PIL decode
on the host, with ``JpegCodec``'s interface (``codec(x)`` -> (decoded,
bpp over the batch's pixels), ``compress``, ``decompress``). PIL is
imported inside the methods, so this module imports where PIL is not
installed; using the codec there raises ImportError.
"""

from __future__ import annotations

import io
from typing import List, Tuple

import numpy as np
import torch


class PilJpegCodec:
    """libjpeg at one quality; decoded batches land on ``device`` (the
    card by default)."""

    def __init__(self, quality: int = 1, device="cuda"):
        from ..utils.device import resolve_device

        self.quality = int(quality)
        self.device = resolve_device(device)

    def compress(self, x) -> List[bytes]:
        """NHWC [0, 1] -> one libjpeg JFIF buffer an image."""
        from PIL import Image

        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        arr = np.clip(np.asarray(x) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        out = []
        for img in arr:
            bio = io.BytesIO()
            Image.fromarray(img).save(bio, "JPEG", quality=self.quality)
            out.append(bio.getvalue())
        return out

    def decompress(self, buffers: List[bytes]) -> torch.Tensor:
        """JFIF buffers (all one size) -> NHWC [0, 1] float32 batch."""
        from PIL import Image

        imgs = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB"), np.float32) / 255.0
                for b in buffers]
        return torch.from_numpy(np.stack(imgs)).to(self.device)

    def __call__(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        buffers = self.compress(x)
        decoded = self.decompress(buffers)
        num_px = x.shape[0] * x.shape[1] * x.shape[2]
        bpp = sum(len(b) for b in buffers) * 8.0 / num_px
        return decoded, torch.tensor(bpp, dtype=torch.float32, device=self.device)
