"""Cheng2020Codec: two-pass checkerboard coding of Cheng2020withCheckerboard.

Counterpart of ``hyres_tpu/models/cheng_codec.py``. The anchor (the odd
parity class, ``CHENG_ANCHOR``) codes first without context, then the
non-anchor with the anchor as context. The contract is ``ElicCodec``'s
(``symbols`` = (z, anchor, non-anchor)); the strings nest differs by
coder:

* host coder: ONE ``BufferedRansEncoder`` stream an image carries both
  passes, anchor first, flushed once, so ``strings`` is
  ``[[y_stream per image], z_strings]``; a decode reads it with one
  ``RansDecoder``, anchor then non-anchor;
* device coder: z and the two classes in ONE K3 launch and one pull in the
  steady state (``models/codec.py pull_encs_dispatch``), one
  frame list a class: ``[[anchor frames, non-anchor frames], z_strings]``.

``decompress`` picks the path from that nesting. The encoder runs the
decoder's stage functions (``dec_anchor``, ``dec_nonanchor``), the
bit-exactness invariant of ``models/codec.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..coding import BufferedRansEncoder, RansDecoder, device_rans
from ..entropy import build_indexes, narrow_symbols_i16, quantize_symbols_i16
from ..jpeg.core import pad_to_multiple
from ..nn.checkerboard import pack, parity_mask, unpack
from ..utils.device import record_event, wait_event
from ..utils.trace import span
from .base import CodecBase
from .cheng2020 import CHENG_ANCHOR, CHENG_NONANCHOR
from .codec import (DevicePlaneCoder, _host, _lut_for, count_host_fallback,
                    pull_encs_dispatch, upload_frames)


def _is_stream_list(y_strings) -> bool:
    """True for the host coder's nest (one bytes stream an image)."""
    return bool(y_strings) and isinstance(y_strings[0], (bytes, bytearray))


class Cheng2020Codec(CodecBase):
    """Cheng2020withCheckerboard + baked CDF tables; host or device coder."""

    # -- stages shared by both sides of the channel ------------------------

    @torch.inference_mode()
    def enc_analysis(self, x: torch.Tensor):
        """Padded NHWC x -> (y float32, z symbols int16)."""
        with span("model.analysis"):
            y, z = self.model.analysis(x)
            return y, quantize_symbols_i16(z, self.model.eb_medians())

    def _indexes(self, scales_packed: torch.Tensor) -> torch.Tensor:
        return build_indexes(scales_packed, self._scale_table_t).to(torch.uint8)

    @torch.inference_mode()
    def dec_anchor(self, z_sym: torch.Tensor):
        """z symbols -> (hyper parameters, anchor indexes u8, packed anchor
        means)."""
        with span("model.params"):
            hyper = self.model.hyper_synthesis(z_sym.to(torch.float32)
                                               + self.model.eb_medians())
            B, H, W, _ = hyper.shape
            zeros = hyper.new_zeros((B, H, W, 2 * self.model.N))
            scales, means = self.model.entropy_params(zeros, hyper)
            return (hyper, self._indexes(pack(scales, CHENG_ANCHOR)),
                    pack(means, CHENG_ANCHOR))

    @torch.inference_mode()
    def dec_nonanchor(self, hyper, a_sym, ma_p):
        """Anchor symbols -> (y_anchor_hat, non-anchor indexes, packed
        non-anchor means)."""
        with span("model.params"):
            y_anchor_hat = unpack(a_sym.to(ma_p.dtype) + ma_p, CHENG_ANCHOR)
            ctx = self.model.context(y_anchor_hat)
            ctx = ctx * parity_mask(ctx.shape[1], ctx.shape[2], CHENG_NONANCHOR,
                                    ctx.dtype, ctx.device)
            scales, means = self.model.entropy_params(ctx, hyper)
            return (y_anchor_hat, self._indexes(pack(scales, CHENG_NONANCHOR)),
                    pack(means, CHENG_NONANCHOR))

    @torch.inference_mode()
    def dec_synthesis(self, y_anchor_hat, n_sym, mn_p) -> torch.Tensor:
        with span("model.synthesis"):
            y_hat = y_anchor_hat + unpack(n_sym.to(mn_p.dtype) + mn_p, CHENG_NONANCHOR)
            x_hat = self.model.synthesis(y_hat)
            if self.clamp is not None:
                x_hat = torch.clamp(x_hat, self.clamp[0], self.clamp[1])
            return x_hat

    @torch.inference_mode()
    def enc_symbols(self, y, means_packed, parity: int):
        return quantize_symbols_i16(pack(y, parity), means_packed)

    # -- compress --------------------------------------------------------------

    def compress(self, x: torch.Tensor) -> Dict:
        return self._compress_finish(self._compress_dispatch(x))

    def latents(self, x: torch.Tensor):
        """Padded NHWC x -> (z symbols, anchor symbols, anchor indexes,
        non-anchor symbols, non-anchor indexes)."""
        y, z_sym = self.enc_analysis(x)
        hyper, a_idx, ma_p = self.dec_anchor(z_sym)
        a_sym = self.enc_symbols(y, ma_p, CHENG_ANCHOR)
        _, n_idx, mn_p = self.dec_nonanchor(hyper, a_sym, ma_p)
        return z_sym, a_sym, a_idx, self.enc_symbols(y, mn_p, CHENG_NONANCHOR), n_idx

    def _compress_dispatch(self, x: torch.Tensor):
        """Async half of compress: analysis, both passes' stages and, under
        the device coder, one K3 launch and the pull, without a wait."""
        self._require_tables()
        start = time.perf_counter()
        with span("compress.dispatch"):
            size = (int(x.shape[1]), int(x.shape[2]))
            syms = self.latents(pad_to_multiple(x.to(self.device, torch.float32), 64))
            latents = (syms, size, start)
            if self.device_coder is None:
                return ("host", latents)
            encs = self.device_coder.encode_all(*syms)
            finish = pull_encs_dispatch(
                encs, cap_state=self.__dict__.setdefault("_enc_cap_state", {}))
            return ("device", (finish, latents))

    def _compress_finish(self, state) -> Dict:
        kind, payload = state
        with span("compress.finish"):
            if kind == "host":
                return self._code_host(*payload)
            finish, latents = payload
            dc = self.device_coder
            try:
                z_strings, a_frames, n_frames = [dc.frames_from_enc(e) for e in finish()[0]]
            except OverflowError as e:
                count_host_fallback(e)
                return self._code_host(*latents)
            (z_sym, a_sym, _, n_sym, _), size, start = latents
            return self._output([a_frames, n_frames], z_strings, (z_sym, a_sym, n_sym),
                                size, start)

    def _code_host(self, syms, size, start) -> Dict:
        z_np, a_np, a_idx, n_np, n_idx = (_host(t) for t in syms)
        gt = self.gauss_tables
        y_strings = []
        with span("coder.encode"):
            for i in range(a_np.shape[0]):
                enc = BufferedRansEncoder()
                enc.encode_with_indexes(a_np[i].ravel(), a_idx[i].ravel(),
                                        gt.quantized_cdf, gt.cdf_length, gt.offset)
                enc.encode_with_indexes(n_np[i].ravel(), n_idx[i].ravel(),
                                        gt.quantized_cdf, gt.cdf_length, gt.offset)
                y_strings.append(enc.flush())
        return self._output(y_strings, self._eb_encode(z_np), (z_np, a_np, n_np),
                            size, start)

    @staticmethod
    def _output(y_strings, z_strings, symbols, size, start) -> Dict:
        z_sym = symbols[0]
        return {
            "strings": [y_strings, z_strings],
            "shape": (int(z_sym.shape[1]), int(z_sym.shape[2])),
            "size": size,
            "symbols": symbols,
            "time": time.perf_counter() - start,
        }

    # -- decompress ------------------------------------------------------------

    def decompress(self, strings, shape: Tuple[int, int],
                   size: Tuple[int, int] | None = None) -> Dict:
        x_hat, symbols, start, done = self._decompress_dispatch(strings, shape, size)
        with span("decompress.wait"):
            wait_event(done)
        return {"x_hat": x_hat, "symbols": symbols,
                "time": time.perf_counter() - start}

    def _dec_dispatch_from_comp(self, comp: Dict):
        return self._decompress_dispatch(comp["strings"], comp["shape"],
                                         comp.get("size"))

    def _decompress_dispatch(self, strings, shape, size=None):
        """Async half of decompress: -> (x_hat, decoded symbols, start, event
        after the last stage)."""
        self._require_tables()
        start = time.perf_counter()
        with span("decompress.dispatch"):
            if _is_stream_list(strings[0]):
                if strings[1] and device_rans.is_device_frame(strings[1][0]):
                    raise ValueError("mixed stream framing in a cheng2020 payload")
                y_anchor_hat, n_sym, mn_p, symbols = self._decode_host(strings, shape)
            elif self.device_coder is None:
                raise ValueError("payload is framed by the device rANS coder; "
                                 "construct the codec with coder='device'")
            else:
                y_anchor_hat, n_sym, mn_p, symbols = self._decode_device(strings, shape)
            x_hat = self.dec_synthesis(y_anchor_hat, n_sym, mn_p)
            if size is not None:
                x_hat = x_hat[:, : size[0], : size[1], :]
            return x_hat, symbols, start, record_event(self.device)

    def _decode_host(self, strings, shape):
        """One RansDecoder an image reads the anchor, then the non-anchor."""
        gt = self.gauss_tables
        lut = _lut_for(gt)
        z_np = narrow_symbols_i16(self._eb_decode(strings[1], shape))
        hyper, a_idx, ma_p = self.dec_anchor(torch.from_numpy(z_np).to(self.device))
        decoders = [RansDecoder(s) for s in strings[0]]

        def read(idx):
            idx = _host(idx)
            with span("coder.decode"):
                return narrow_symbols_i16(np.stack([
                    d.decode_stream(idx[i], gt.quantized_cdf, gt.cdf_length, gt.offset,
                                    lut=lut) for i, d in enumerate(decoders)]))

        a_np = read(a_idx)
        y_anchor_hat, n_idx, mn_p = self.dec_nonanchor(
            hyper, torch.from_numpy(a_np).to(self.device), ma_p)
        n_np = read(n_idx)
        return (y_anchor_hat, torch.from_numpy(n_np).to(self.device), mn_p,
                (z_np, a_np, n_np))

    def _decode_device(self, strings, shape):
        """ONE upload, then K5, the anchor stage, K4, the non-anchor stage,
        K4, with no host synchronisation."""
        dc = self.device_coder
        B = len(strings[1])
        C = self.eb_tables.cdf_length.shape[0]
        n_y = shape[0] * 4 * shape[1] * 2 * self.model.N  # packed half-width
        unframed = [DevicePlaneCoder.unframe_batch(strings[1], shape[0] * shape[1] * C),
                    DevicePlaneCoder.unframe_batch(strings[0][0], n_y),
                    DevicePlaneCoder.unframe_batch(strings[0][1], n_y)]
        if any(u is None for u in unframed):
            raise ValueError("mixed stream framing in a cheng2020 payload")
        (uz, ua, un), _ = upload_frames(unframed, self.device)
        z_sym = dc.decode_eb(uz[2], uz[1], uz[3], uz[4], (B, shape[0], shape[1], C), uz[0])
        hyper, a_idx, ma_p = self.dec_anchor(z_sym)
        a_sym = dc.decode_gauss(ua[2], ua[1], a_idx, ua[3], ua[4], ua[0])
        y_anchor_hat, n_idx, mn_p = self.dec_nonanchor(hyper, a_sym, ma_p)
        n_sym = dc.decode_gauss(un[2], un[1], n_idx, un[3], un[4], un[0])
        return y_anchor_hat, n_sym, mn_p, (z_sym, a_sym, n_sym)
