"""ElicCodec: per-slice entropy-coded compress/decompress of LightWeightELIC.

Counterpart of ``hyres_tpu/models/elic_codec.py``. Per slice, the anchor
class codes first, then the non-anchor class with the anchor as context;
each class is a width-halved dense packing of its parity. The contract:

  compress -> {"strings": [y_strings, z_strings], "shape", "size",
               "symbols", "time"}
  decompress(strings, shape, size) -> {"x_hat", "symbols", "time"}

``y_strings`` interleaves the slices' classes (anchor 0, non-anchor 0,
anchor 1, ...), each a list of per-image frames; ``symbols`` is (z,
anchor 0, non-anchor 0, ...), int16 numpy with the host coder and tensors
on the codec's device with the device coder.

Bit-exactness invariant (``models/codec.py``): the encoder runs the
decoder's stage functions (``dec_hyper``, ``dec_support``, ``dec_anchor``,
``dec_nonanchor``, ``dec_combine``) in the decoder's order, through one
chain (``_slice_chain``), and only adds the symbols of its own ``y``.

Coders. The host coder codes the 2 * slices + 1 planes on the host, each
into chunked frames. The device coder encodes every plane in ONE K3
launch and pulls them through the sliced wire, one copy in the steady
state (``models/codec.py pull_encs_dispatch``; ``_compress_dispatch`` /
``_compress_finish``, the halves ``CodecBase.inference_stream``
interleaves); a decode is one unframe and ONE upload, then K5 for z and
two K4 launches a slice between the slice stages, with no host
synchronisation before ``x_hat``. A plane over its stream cap or escape
list re-codes the whole request with the host coder, counted in
``WIRE_STATS``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

from ..coding import device_rans
from ..entropy import build_indexes, narrow_symbols_i16, quantize_symbols_i16
from ..jpeg.core import pad_to_multiple
from ..nn.checkerboard import ANCHOR, NON_ANCHOR, pack, unpack
from ..utils.device import record_event, wait_event
from ..utils.trace import span
from .base import CodecBase
from .codec import (DevicePlaneCoder, _decode_planes, _encode_planes, _host,
                    count_host_fallback, pull_encs_dispatch, upload_frames)


class ElicCodec(CodecBase):
    """LightWeightELIC + baked CDF tables; host or device rANS coder."""

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

    def _indexes(self, scales_packed: torch.Tensor) -> torch.Tensor:
        return build_indexes(scales_packed, self._scale_table_t).to(torch.uint8)

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

    def _slice_chain(self, z_sym, code: Callable) -> List[torch.Tensor]:
        """The slice stages in the decoder's order. ``code(k, idx, means)``
        gives plane k's symbols (k = 2 i for slice i's anchor, 2 i + 1 for
        its non-anchor) from its indexes and packed means: the encoder
        quantizes its y, the decoder decodes. Returns the slices' y_hat."""
        with span("model.params"):
            means, scales = self.dec_hyper(z_sym)
        y_hat: List[torch.Tensor] = []
        for i in range(len(self.model.groups)):
            with span("model.params"):
                support = self.dec_support(i, y_hat[0] if y_hat else None,
                                           y_hat[-1] if y_hat else None, means, scales)
                a_idx, ma_p = self.dec_anchor(i, support)
            a_sym = code(2 * i, a_idx, ma_p)
            with span("model.params"):
                y_anchor_hat, n_idx, mn_p = self.dec_nonanchor(i, support, a_sym, ma_p)
            n_sym = code(2 * i + 1, n_idx, mn_p)
            with span("model.params"):
                y_hat.append(self.dec_combine(y_anchor_hat, n_sym, mn_p))
        return y_hat

    # -- compress --------------------------------------------------------------

    def compress(self, x: torch.Tensor) -> Dict:
        return self._compress_finish(self._compress_dispatch(x))

    def latents(self, x: torch.Tensor):
        """Padded NHWC x -> (z symbols, [(symbols, indexes)] of the y planes
        in coding order: anchor 0, non-anchor 0, anchor 1, ...)."""
        y, z_sym = self.enc_analysis(x)
        y_slices = torch.split(y, self.model.groups, dim=-1)
        planes: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def code(k, idx, means):
            sym = self.enc_symbols(y_slices[k // 2], means, NON_ANCHOR if k % 2 else ANCHOR)
            planes.append((sym, idx))
            return sym

        self._slice_chain(z_sym, code)
        return z_sym, planes

    def device_jobs(self, z_sym, planes) -> List[device_rans.PlaneJob]:
        """The device coder's encode jobs: the y planes, then z."""
        dc = self.device_coder
        return [dc.gauss_job(s, i) for s, i in planes] + [dc.eb_job(z_sym)]

    def _compress_dispatch(self, x: torch.Tensor):
        """Async half of compress: analysis, the slice chain and, under the
        device coder, one K3 launch for every plane and the pull, enqueued
        without a wait. The host coder codes in the finish half."""
        self._require_tables()
        start = time.perf_counter()
        with span("compress.dispatch"):
            size = (int(x.shape[1]), int(x.shape[2]))
            z_sym, planes = self.latents(pad_to_multiple(x.to(self.device, torch.float32), 64))
            latents = (z_sym, planes, size, start)
            if self.device_coder is None:
                return ("host", latents)
            with span("coder.encode"):
                encs = device_rans.encode(self.device_jobs(z_sym, planes))
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
                frames = [dc.frames_from_enc(e) for e in finish()[0]]
            except OverflowError as e:
                count_host_fallback(e)
                return self._code_host(*latents)
            z_sym, planes, size, start = latents
            return self._output(frames[:-1], frames[-1], z_sym,
                                tuple(s for s, _ in planes), size, start)

    def _code_host(self, z_sym, planes, size, start) -> Dict:
        syms = [_host(s) for s, _ in planes]
        y_strings = [_encode_planes(s, _host(i), self.gauss_tables)
                     for s, (_, i) in zip(syms, planes)]
        z_np = _host(z_sym)
        return self._output(y_strings, self._eb_encode(z_np), z_np, syms, size, start)

    @staticmethod
    def _output(y_strings, z_strings, z_sym, syms, size, start) -> Dict:
        return {
            "strings": [y_strings, z_strings],
            "shape": (int(z_sym.shape[1]), int(z_sym.shape[2])),
            "size": size,
            "symbols": (z_sym, *syms),
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
        after the last stage). The device path queues its whole chain
        without a wait; the host coder synchronises between slices."""
        self._require_tables()
        start = time.perf_counter()
        with span("decompress.dispatch"):
            out = None
            if self.device_coder is not None:
                out = self._decode_device(strings, shape)
            elif strings[1] and device_rans.is_device_frame(strings[1][0]):
                raise ValueError("payload is framed by the device rANS coder; "
                                 "construct the codec with coder='device'")
            if out is None:
                out = self._decode_host(strings, shape)
            y_hat, symbols = out
            x_hat = self.dec_synthesis(y_hat)
            if size is not None:
                x_hat = x_hat[:, : size[0], : size[1], :]
            return x_hat, symbols, start, record_event(self.device)

    def _decode_host(self, strings, shape):
        z_np = narrow_symbols_i16(self._eb_decode(strings[1], shape))
        syms = []

        def code(k, idx, _means):
            s = narrow_symbols_i16(_decode_planes(strings[0][k], _host(idx),
                                                  self.gauss_tables))
            syms.append(s)
            return torch.from_numpy(s).to(self.device)

        y_hat = self._slice_chain(torch.from_numpy(z_np).to(self.device), code)
        return y_hat, (z_np, *syms)

    def _decode_device(self, strings, shape):
        """ONE upload, then K5 and the slice chain with two K4 launches a
        slice, no host synchronisation. None if any plane is host-framed."""
        dc = self.device_coder
        B = len(strings[1])
        C = self.eb_tables.cdf_length.shape[0]
        H, W = shape[0] * 4, shape[1] * 4
        unframed = [DevicePlaneCoder.unframe_batch(strings[0][2 * i + k], H * (W // 2) * g)
                    for i, g in enumerate(self.model.groups) for k in (0, 1)]
        unframed.append(DevicePlaneCoder.unframe_batch(strings[1], shape[0] * shape[1] * C))
        if any(u is None for u in unframed):
            return None
        planes, _ = upload_frames(unframed, self.device)
        uz = planes[-1]
        z_sym = dc.decode_eb(uz[2], uz[1], uz[3], uz[4], (B, shape[0], shape[1], C), uz[0])
        syms = []

        def code(k, idx, _means):
            u = planes[k]
            s = dc.decode_gauss(u[2], u[1], idx, u[3], u[4], u[0])
            syms.append(s)
            return s

        y_hat = self._slice_chain(z_sym, code)
        return y_hat, (z_sym, *syms)
