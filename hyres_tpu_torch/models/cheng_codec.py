"""Cheng2020Codec: two-pass checkerboard coding of Cheng2020withCheckerboard.

Counterpart of ``hyres_tpu/models/cheng_codec.py``. The anchor (the odd
parity class, ``CHENG_ANCHOR``) codes first without context, then the
non-anchor with the anchor as context, through ``models/base.py
CodecBase``'s protocol (``symbols`` = (z, anchor, non-anchor)). The
strings nest differs by coder:

* host coder: ONE ``BufferedRansEncoder`` stream an image carries both
  passes, anchor first, flushed once, so ``strings`` is
  ``[[y_stream per image], z_strings]``; a decode reads it with one
  ``RansDecoder``, anchor then non-anchor (``_host_y_encode``,
  ``_host_y_reader``);
* device coder: one frame list a class, ``[[anchor frames, non-anchor
  frames], z_strings]``.

``_framed_by_device`` reads which from that nesting. On a card, g_a, h_a
and g_s (``enc_analysis``, ``dec_synthesis``) run cuDNN's autotuned
float32 algorithms (``utils/device.py autotuned_float32``): no decoder
recomputes their outputs, and for a 768x512 (height x width) image the
deterministic algorithms that cuDNN's heuristics pick for them take some
0.7 s a call. h_s, the context and the entropy parameters, which both
sides compute, keep the coder path's deterministic ones.

A Gaussian-mixture model (``mixtures > 1``) codes on the device coder
only: its symbols are ``round(y)`` and ``y_hat`` is the symbols; in place
of scale indexes and means, each stage gives the parity's mixture rows
from K6 (``DevicePlaneCoder.gmm_rows``), built on both sides from the
same stage outputs (``_coding``), and K3 and the mixture decode code
against them. Its planes never re-frame with the host coder: an overflow
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coding import BufferedRansEncoder, RansDecoder
from ..entropy import quantize_symbols_i16
from ..nn.checkerboard import pack, parity_mask, unpack
from ..utils.device import autotuned_float32
from ..utils.trace import span
from .base import CodecBase
from .cheng2020 import CHENG_ANCHOR, CHENG_NONANCHOR
from .codec import _lut_for


class Cheng2020Codec(CodecBase):
    """Cheng2020withCheckerboard + baked CDF tables; host or device coder
    (a mixture model: the device coder alone)."""

    def __init__(self, model, clamp=(0.0, 1.0), coder: str = "host", device="cuda"):
        self.mixtures = getattr(model, "mixtures", 1)
        if self.mixtures > 1 and coder != "device":
            raise ValueError(
                f"a Cheng2020 with a {self.mixtures}-component Gaussian mixture codes "
                "only with the device coder (coder='device'): the host coder has no "
                "per-element rows")
        super().__init__(model, clamp=clamp, coder=coder, device=device)

    # -- stages shared by both sides of the channel ------------------------

    @torch.inference_mode()
    def enc_analysis(self, x: torch.Tensor):
        """Padded NHWC x -> (y float32, z symbols int16)."""
        with span("model.analysis"), autotuned_float32(x.device):
            y, z = self.model.analysis(x)
            return y, quantize_symbols_i16(z, self.model.eb_medians())

    def _coding(self, p: torch.Tensor, parity: int):
        """A parity's coding inputs from the entropy parameters: (scale
        indexes u8, packed means), or a mixture's (rows, None)."""
        if self.mixtures > 1:
            return self.device_coder.gmm_rows(pack(p, parity), self.mixtures), None
        scales, means = p.chunk(2, dim=-1)
        return self._indexes(pack(scales, parity)), pack(means, parity)

    @staticmethod
    def _y_hat(sym: torch.Tensor, means_p, parity: int) -> torch.Tensor:
        """A parity's y_hat: symbols plus means (a mixture's: the symbols)."""
        y = sym.to(torch.float32)
        return unpack(y if means_p is None else y + means_p, parity)

    @torch.inference_mode()
    def dec_anchor(self, z_sym: torch.Tensor):
        """z symbols -> (hyper parameters, anchor indexes u8, packed anchor
        means); a mixture's (hyper, anchor rows, None)."""
        with span("model.params"):
            hyper = self.model.hyper_synthesis(z_sym.to(torch.float32)
                                               + self.model.eb_medians())
            B, H, W, _ = hyper.shape
            zeros = hyper.new_zeros((B, H, W, 2 * self.model.N))
            p = self.model.mixture_params(zeros, hyper)
        return (hyper, *self._coding(p, CHENG_ANCHOR))

    @torch.inference_mode()
    def dec_nonanchor(self, hyper, a_sym, ma_p):
        """Anchor symbols -> (y_anchor_hat, non-anchor indexes, packed
        non-anchor means); a mixture's (y_anchor_hat, rows, None)."""
        with span("model.params"):
            y_anchor_hat = self._y_hat(a_sym, ma_p, CHENG_ANCHOR)
            ctx = self.model.context(y_anchor_hat)
            ctx = ctx * parity_mask(ctx.shape[1], ctx.shape[2], CHENG_NONANCHOR,
                                    ctx.dtype, ctx.device)
            p = self.model.mixture_params(ctx, hyper)
        return (y_anchor_hat, *self._coding(p, CHENG_NONANCHOR))

    @torch.inference_mode()
    def dec_synthesis(self, y_anchor_hat, n_sym, mn_p) -> torch.Tensor:
        with span("model.synthesis"):
            y_hat = y_anchor_hat + self._y_hat(n_sym, mn_p, CHENG_NONANCHOR)
            with autotuned_float32(y_hat.device):
                x_hat = self.model.synthesis(y_hat)
            if self.clamp is not None:
                x_hat = torch.clamp(x_hat, self.clamp[0], self.clamp[1])
            return x_hat

    @torch.inference_mode()
    def enc_symbols(self, y, means_packed, parity: int):
        """A parity's symbols: round(y - means), a mixture's round(y)."""
        return quantize_symbols_i16(pack(y, parity), means_packed)

    # -- the family's part of the protocol (models/base.py) -----------------

    def _chain(self, z_sym, code, y=None):
        """The anchor pass, then the non-anchor pass."""
        hyper, a_coding, ma_p = self.dec_anchor(z_sym)
        a_sym = code(a_coding, None if y is None else self.enc_symbols(y, ma_p, CHENG_ANCHOR))
        y_anchor_hat, n_coding, mn_p = self.dec_nonanchor(hyper, a_sym, ma_p)
        n_sym = code(n_coding, None if y is None else self.enc_symbols(y, mn_p, CHENG_NONANCHOR))
        return y_anchor_hat, n_sym, mn_p

    def _synthesis(self, chained) -> torch.Tensor:
        return self.dec_synthesis(*chained)

    def _y_planes(self, shape):
        return [(4 * shape[0], 2 * shape[1], self.model.N)] * 2  # packed half-width

    # -- the host coder's format: one stream an image carries both passes ---

    def _host_y_encode(self, planes) -> list:
        gt = self.gauss_tables
        streams = []
        with span("coder.encode"):
            for i in range(planes[0][0].shape[0]):
                enc = BufferedRansEncoder()
                for sym, idx in planes:
                    enc.encode_with_indexes(sym[i].ravel(), idx[i].ravel(),
                                            gt.quantized_cdf, gt.cdf_length, gt.offset)
                streams.append(enc.flush())
        return streams

    def _host_y_reader(self, y_streams):
        """One RansDecoder an image reads the anchor, then the non-anchor."""
        gt = self.gauss_tables
        lut = _lut_for(gt)
        decoders = [RansDecoder(s) for s in y_streams]

        def read(idx):
            with span("coder.decode"):
                return np.stack([d.decode_stream(idx[i], gt.quantized_cdf, gt.cdf_length,
                                                 gt.offset, lut=lut)
                                 for i, d in enumerate(decoders)])
        return read

    def _framed_by_device(self, strings) -> bool:
        """The host coder's nest holds one stream an image, the device
        coder's a frame list a plane."""
        y = strings[0]
        if not (y and isinstance(y[0], (bytes, bytearray))):
            return True
        if self.mixtures > 1:
            raise ValueError("a mixture payload is framed by the device coder; "
                             "this one holds host-coder streams")
        if super()._framed_by_device(strings):
            raise ValueError("mixed stream framing in a cheng2020 payload")
        return False
