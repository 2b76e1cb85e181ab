"""TcmCodec: the slice chain of TCM, entropy coded.

TCM's y codes in its channel slices, one whole plane a slice (no
checkerboard): slice i's means and scales come from SWAtten and the 3x3
stacks on the hyper parameters and the slices before it, its symbols are
round(y_i - means), its y_hat the symbols plus the means refined by the
LRP. It serves through ``models/base.py CodecBase``'s protocol;
``strings`` is ``[y_strings, z_strings]``, ``y_strings`` a frame list a
slice, and ``symbols`` is (z, slice 0, ..., slice 4). The input pads to a
multiple of 128 (``PAD``), as LIC_TCM's evaluation does, so that every
window of every stage is whole.

Bit-exactness invariant (``models/codec.py``): the encoder runs the
decoder's stages in the decoder's order through one chain (``_chain``) and
only adds the symbols of its own y. On the device coder its K3 jobs, its
pull and its decode upload put the y planes first and z last
(``Z_LAST``), as ELIC's. On a card g_a, h_a and g_s (``enc_analysis``,
``dec_synthesis``) run cuDNN's autotuned float32 algorithms (no decoder
recomputes their outputs); h_mean_s, h_scale_s and the slice stages,
which both sides compute, keep the coder path's deterministic ones, and
their attention is K7, which is deterministic and batch-invariant.
"""

from __future__ import annotations

from typing import List

import torch

from ..entropy import quantize_symbols_i16
from ..utils.device import autotuned_float32
from ..utils.trace import span
from .base import CodecBase


class TcmCodec(CodecBase):
    """TCM + baked CDF tables; host or device rANS coder."""

    Z_LAST = True
    PAD = 128

    @torch.inference_mode()
    def enc_analysis(self, x: torch.Tensor):
        """Padded NHWC x -> (y float32, z symbols int16)."""
        with span("model.analysis"), autotuned_float32(x.device):
            y, z = self.model.analysis(x)
            return y, quantize_symbols_i16(z, self.model.eb_medians())

    @torch.inference_mode()
    def dec_hyper(self, z_sym: torch.Tensor):
        """z symbols -> (latent means, latent scales)."""
        return self.model.hyper_synthesis(z_sym.to(torch.float32) + self.model.eb_medians())

    @torch.inference_mode()
    def dec_slice(self, i: int, means, scales, y_hat: List[torch.Tensor]):
        """-> (slice i's mean support, scale indexes u8, means)."""
        ms, mu, sigma = self.model.slice_params(i, means, scales, y_hat)
        return ms, self._indexes(sigma), mu

    @torch.inference_mode()
    def dec_refine(self, i: int, ms, sym, mu):
        return self.model.slice_refine(i, ms, sym.to(mu.dtype) + mu)

    @torch.inference_mode()
    def dec_synthesis(self, y_hat: List[torch.Tensor]) -> torch.Tensor:
        with span("model.synthesis"):
            with autotuned_float32(y_hat[0].device):
                x_hat = self.model.synthesis(torch.cat(y_hat, dim=-1))
            if self.clamp is not None:
                x_hat = torch.clamp(x_hat, self.clamp[0], self.clamp[1])
            return x_hat

    # -- the family's part of the protocol (models/base.py) -----------------

    def _chain(self, z_sym, code, y=None) -> List[torch.Tensor]:
        """The slices in order, each one plane. Returns the slices' y_hat."""
        ys = None if y is None else torch.split(y, self.model.slice_channels, dim=-1)
        with span("model.params"):
            means, scales = self.dec_hyper(z_sym)
        y_hat: List[torch.Tensor] = []
        for i in range(self.model.slices):
            with span("model.params"):
                ms, idx, mu = self.dec_slice(i, means, scales, y_hat)
            sym = code(idx, None if y is None else quantize_symbols_i16(ys[i], mu))
            with span("model.params"):
                y_hat.append(self.dec_refine(i, ms, sym, mu))
        return y_hat

    def _synthesis(self, y_hat) -> torch.Tensor:
        return self.dec_synthesis(y_hat)

    def _y_planes(self, shape):
        return [(4 * shape[0], 4 * shape[1], self.model.slice_channels)] * self.model.slices
