"""ElicCodec: per-slice entropy-coded compress/decompress of LightWeightELIC.

Counterpart of ``hyres_tpu/models/elic_codec.py``. Per slice, the anchor
class codes first, then the non-anchor class with the anchor as context;
each class is a width-halved dense packing of its parity. It serves
through ``models/base.py CodecBase``'s protocol; ``strings`` is
``[y_strings, z_strings]``, where ``y_strings`` interleaves the slices'
classes (anchor 0, non-anchor 0, anchor 1, ...), each a list of per-image
frames, and ``symbols`` is (z, anchor 0, non-anchor 0, ...).

Bit-exactness invariant (``models/codec.py``): the encoder runs the
decoder's stage functions (``dec_hyper``, ``dec_support``, ``dec_anchor``,
``dec_nonanchor``, ``dec_combine``) in the decoder's order, through one
chain (``_chain``), and only adds the symbols of its own ``y``. On the
device coder its K3 jobs, its pull and its decode upload put the y
planes first and z last (``Z_LAST``), as the reference does.
"""

from __future__ import annotations

from typing import List

import torch

from ..entropy import quantize_symbols_i16
from ..nn.checkerboard import ANCHOR, NON_ANCHOR, pack, unpack
from ..utils.trace import span
from .base import CodecBase


class ElicCodec(CodecBase):
    """LightWeightELIC + baked CDF tables; host or device rANS coder."""

    Z_LAST = True

    # -- stages shared by both sides of the channel ------------------------

    @torch.inference_mode()
    def enc_analysis(self, x: torch.Tensor):
        """Padded NHWC x -> (y float32, z symbols int16)."""
        with span("model.analysis"):
            y, z = self.model.analysis(x)
            return y, quantize_symbols_i16(z, self.model.eb_medians())

    @torch.inference_mode()
    def dec_hyper(self, z_sym: torch.Tensor):
        """z symbols -> (latent means, latent scales)."""
        return self.model.hyper_synthesis(z_sym.to(torch.float32)
                                          + self.model.eb_medians())

    @torch.inference_mode()
    def dec_support(self, i: int, y_first, y_prev, means, scales):
        return self.model.slice_support(i, y_first, y_prev, means, scales)

    @torch.inference_mode()
    def dec_anchor(self, i: int, support):
        """-> (anchor indexes u8, packed anchor means)."""
        m, s = self.model.slice_anchor_params(i, support)
        return self._indexes(pack(s, ANCHOR)), pack(m, ANCHOR)

    @torch.inference_mode()
    def dec_nonanchor(self, i: int, support, a_sym, ma_p):
        """Anchor symbols -> (y_anchor_hat, non-anchor indexes, packed
        non-anchor means)."""
        y_anchor_hat = unpack(a_sym.to(ma_p.dtype) + ma_p, ANCHOR)
        m, s = self.model.slice_nonanchor_params(i, support, y_anchor_hat)
        return y_anchor_hat, self._indexes(pack(s, NON_ANCHOR)), pack(m, NON_ANCHOR)

    @torch.inference_mode()
    def dec_combine(self, y_anchor_hat, n_sym, mn_p):
        return y_anchor_hat + unpack(n_sym.to(mn_p.dtype) + mn_p, NON_ANCHOR)

    @torch.inference_mode()
    def dec_synthesis(self, y_hat_slices: List[torch.Tensor]) -> torch.Tensor:
        with span("model.synthesis"):
            x_hat = self.model.synthesis(torch.cat(y_hat_slices, dim=-1))
            if self.clamp is not None:
                x_hat = torch.clamp(x_hat, self.clamp[0], self.clamp[1])
            return x_hat

    @torch.inference_mode()
    def enc_symbols(self, y_slice, means_packed, parity: int):
        return quantize_symbols_i16(pack(y_slice, parity), means_packed)

    # -- the family's part of the protocol (models/base.py) -----------------

    def _chain(self, z_sym, code, y=None) -> List[torch.Tensor]:
        """The slice stages in the decoder's order: per slice its anchor
        plane, then its non-anchor plane. Returns the slices' y_hat."""
        y_slices = None if y is None else torch.split(y, self.model.groups, dim=-1)
        with span("model.params"):
            means, scales = self.dec_hyper(z_sym)
        y_hat: List[torch.Tensor] = []
        for i in range(len(self.model.groups)):
            with span("model.params"):
                support = self.dec_support(i, y_hat[0] if y_hat else None,
                                           y_hat[-1] if y_hat else None, means, scales)
                a_idx, ma_p = self.dec_anchor(i, support)
            a_sym = code(a_idx, None if y is None
                         else self.enc_symbols(y_slices[i], ma_p, ANCHOR))
            with span("model.params"):
                y_anchor_hat, n_idx, mn_p = self.dec_nonanchor(i, support, a_sym, ma_p)
            n_sym = code(n_idx, None if y is None
                         else self.enc_symbols(y_slices[i], mn_p, NON_ANCHOR))
            with span("model.params"):
                y_hat.append(self.dec_combine(y_anchor_hat, n_sym, mn_p))
        return y_hat

    def _synthesis(self, y_hat) -> torch.Tensor:
        return self.dec_synthesis(y_hat)

    def _y_planes(self, shape):
        H, W = 4 * shape[0], 4 * shape[1]
        return [(H, W // 2, g) for g in self.model.groups for _ in (ANCHOR, NON_ANCHOR)]
