"""HyRES composite codec: JPEG base layer + neural residual + refinement.

Counterpart of ``hyres_tpu/models/hyres.py``: ``ResidualJPEGCompression``
(the training forward with the JPEG base layer under no gradient,
``:75-105``, ``refine_stage`` and ``aux_loss``) and ``HyresCodec`` with
the host or the device rANS coder (``enc_front``, ``_compress_dispatch``,
``_compress_finish``, ``_dec_dispatch_from_comp``, ``dec_final``,
``inference``, ``inference_stream``, reference ``:108-356``).

  compress:   JPEG coefficients (K1) -> JPEG decode (K2) -> residual ->
              g_a/h_a -> checkerboard stages -> rANS (host, or K3 on the
              card) + JFIF bytes
  decompress: residual decode stages (host rANS, or K5/K4 on the card)
              -> residual synthesis -> JFIF parse -> coefficient upload ->
              dequant/IDCT (K2) -> refinement

K1 and K2 each take the three planes of a request in one launch, with
the quant tables as host values: the JPEG path adds no launch a plane,
no copy and no synchronisation, so the decode tail's host dispatch
overlaps the decode stages still running on the card.

The JPEG coefficients cross between host and card int8 when every value
fits, else int16. A compress under the device coder pulls them with the
coder's planes (``models/codec.py pull_encs_dispatch``): dense on a first
call, then as the active columns of their 8x8 blocks. A decompress
uploads them as sparse (pos int32, val int16) pairs whenever those are
smaller than the dense plane (reference ``hyres.py:300-320``) and
scatters them on the card. Under the device coder it parses the JFIF
bytes only once the residual's decode chain and synthesis are queued, so
the parse runs on the host while the card decodes, and uploads the
coefficients in a second copy behind them.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy import quantize_symbols_i16
from ..jpeg import (ParsedJpeg, decode_from_coefficients, decode_jfif, decode_with_qtables,
                    encode_to_coefficients, jpeg_roundtrip)
from ..jpeg.bitstream import assemble_batch, check_420, coef_bytes
from ..jpeg.core import coefs_from_bytes
from ..jpeg.tables import quality_to_qtables
from ..nn import MultiScaleRefine
from ..utils.device import record_event, wait_event
from ..utils.trace import span
from .base import CodecBase
from .checkerboard import LightWeightCheckerboard, to_nchw, to_nhwc
from .codec import (_COEF_BUCKET, WIRE_STATS, CheckerboardCodec, _bucket, _host,
                    pad_to_multiple, upload_bytes)


def _coef_fit_int8(quality: int) -> bool:
    """True when the quality's quant tables bound every coefficient to
    int8: |DCT coeff| of a level-shifted 8x8 block is < 1024, so a
    minimum quant step of 9 guarantees |quantized| <= 113 < 128."""
    qy, qc = quality_to_qtables(quality)
    return int(min(qy.min(), qc.min())) >= 9


def sparse_coef_bytes(coef_u8: np.ndarray, dtype: np.dtype):
    """The decompress upload's coefficient layout (reference
    ``hyres.py:300-320``): (B, n) dense bytes of ``coef_bytes`` -> (bytes
    to upload, sparse cap or None). Sparse [pos int32 * cap][val int16 *
    cap] pairs, positions padded with n, whenever 6 * cap < n * itemsize,
    cap being the batch's largest nonzero count bucketed by
    ``_COEF_BUCKET``; else the dense bytes."""
    flat = coef_u8.view(dtype)
    B, n = flat.shape
    mask = flat != 0  # np.flatnonzero of a boolean plane is several times faster
    nnz = max((int(np.count_nonzero(row)) for row in mask), default=0)
    cap = min(n, _bucket(nnz, _COEF_BUCKET))
    if 6 * cap >= n * flat.dtype.itemsize:
        return coef_u8, None
    pos = np.full((B, cap), n, np.int32)
    val = np.zeros((B, cap), np.int16)
    for i in range(B):
        nz = np.flatnonzero(mask[i])
        pos[i, :nz.size] = nz
        val[i, :nz.size] = flat[i, nz]
    return np.concatenate([pos.view(np.uint8), val.view(np.uint8)], axis=1), cap


class ResidualJPEGCompression(nn.Module):
    """JPEG base + checkerboard residual codec + multi-scale refinement.

    ``compute_dtype`` (None = float32, or torch.bfloat16) runs the
    residual transforms and the refinement CNN; the JPEG path stays
    float32.
    """

    def __init__(self, N: int = 128, M: int = 192, jpeg_quality: int = 1,
                 compute_dtype=None):
        super().__init__()
        self.N, self.M, self.jpeg_quality = N, M, int(jpeg_quality)
        self.compute_dtype = compute_dtype
        self.residual_model = LightWeightCheckerboard(N, M, compute_dtype=compute_dtype)
        self.refine = MultiScaleRefine(mid_channels=64)

    def refine_stage(self, x_initial: torch.Tensor) -> torch.Tensor:
        """NHWC x_initial -> clamp(x_initial + refine(x_initial), 0, 1)."""
        xc = x_initial if self.compute_dtype is None else x_initial.to(self.compute_dtype)
        delta = to_nhwc(self.refine(to_nchw(xc)).float())
        return torch.clamp(x_initial + delta, 0.0, 1.0)

    def aux_loss(self) -> torch.Tensor:
        return self.residual_model.aux_loss()

    def draw_noise(self, x_shape, generator: torch.Generator, noisequant: bool, device):
        """The residual codec's draws for an input of ``x_shape``."""
        return self.residual_model.draw_noise(x_shape, generator, noisequant, device)

    def forward(self, x: torch.Tensor, noisequant: bool = False,
                generator: torch.Generator | None = None, noise=None,
                remat: bool = False) -> Dict:
        """Training forward on an NHWC [0,1] batch. The JPEG base layer
        (one K1 and one K2 launch on a card) runs with no gradient and its
        rate enters the loss as an observed constant. Returns
        ``{"x_hat", "likelihoods", "jpeg_bpp_loss", "jpeg_decoded",
        "residual", "residual_hat"}``. ``remat`` recomputes the residual
        codec and the refinement (not the JPEG layer) in the backward."""
        if noise is None and generator is not None:
            noise = self.draw_noise(x.shape, generator, noisequant, x.device)
        jpeg_decoded, jpeg_bpp = jpeg_roundtrip(x, self.jpeg_quality)
        residual = x - jpeg_decoded
        if remat:
            res_out, x_hat = checkpoint(self._codec, residual, jpeg_decoded, noisequant,
                                        noise, use_reentrant=False)
        else:
            res_out, x_hat = self._codec(residual, jpeg_decoded, noisequant, noise)
        return {"x_hat": x_hat, "likelihoods": res_out["likelihoods"],
                "jpeg_bpp_loss": torch.mean(jpeg_bpp), "jpeg_decoded": jpeg_decoded,
                "residual": residual, "residual_hat": res_out["x_hat"]}

    def _codec(self, residual, jpeg_decoded, noisequant: bool, noise):
        res_out = self.residual_model(residual, noisequant=noisequant, noise=noise)
        return res_out, self.refine_stage(jpeg_decoded + res_out["x_hat"])


class HyresCodec:
    """Deployment wrapper: real JPEG buffers + residual strings.

    ``compress`` returns the residual codec dict plus ``jpeg_buffers``;
    ``decompress`` takes that dict and returns ``{"x_hat", "symbols",
    "time"}``. coder: "host" or "device" (see ``CodecBase``).
    """

    def __init__(self, model: ResidualJPEGCompression, coder: str = "host",
                 device="cuda"):
        # clamp=None: the inner codec carries a signed residual
        self._residual = CheckerboardCodec(model.residual_model, clamp=None,
                                           coder=coder, device=device)
        self.device = self._residual.device
        self.model = model.to(self.device).eval()

    @classmethod
    def from_artifact(cls, path, compute_dtype=None, device="cuda",
                      coder: str = "host") -> "HyresCodec":
        """Codec from a trained HyRES artifact (flax msgpack with
        ``config``, ``params`` and baked ``tables``), tables installed."""
        from ..utils.convert import load_state_dict
        from ..utils.flax_msgpack import load_artifact

        config, params, tables = load_artifact(path)
        model = ResidualJPEGCompression(config["N"], config["M"],
                                        config["jpeg_quality"], compute_dtype)
        load_state_dict(model, params)
        codec = cls(model, coder=coder, device=device)
        codec.install_tables(tables)
        return codec

    def update(self, scale_table=None, force: bool = False) -> bool:
        return self._residual.update(scale_table=scale_table, force=force)

    def install_tables(self, tables: dict) -> None:
        self._residual.install_tables(tables)

    # -- encoder ---------------------------------------------------------

    @torch.inference_mode()
    def enc_front(self, x: torch.Tensor):
        """JPEG coefficients + JPEG decode + residual + g_a/h_a analysis."""
        q = self.model.jpeg_quality
        with span("model.jpeg"):
            coef = encode_to_coefficients(x, q)
            dec = decode_from_coefficients(coef.y, coef.cb, coef.cr, q,
                                           x.shape[1], x.shape[2])
        r = self._residual
        with span("model.analysis"):
            y, z = r.model.analysis(pad_to_multiple(x - dec, 64))
            z_sym = quantize_symbols_i16(z, r.model.eb_medians())
        return (coef.y, coef.cb, coef.cr), y, z_sym

    def compress(self, x: torch.Tensor) -> Dict:
        """NHWC [0,1] batch -> {"strings", "shape", "size", "symbols",
        "jpeg_buffers", "time"}."""
        return self._compress_finish(self._compress_dispatch(x))

    def _compress_dispatch(self, x: torch.Tensor):
        """Async half of compress (``inference_stream``): the JPEG front
        (one K1 launch, K2 once for the JPEG decode), the residual stages,
        K3 and the pull enqueue without a wait under the device coder; the
        JPEG coefficients ride the same pull."""
        r = self._residual
        r._require_tables()
        start = time.perf_counter()
        with span("compress.dispatch"):
            x = x.to(self.device, torch.float32)
            size = (int(x.shape[1]), int(x.shape[2]))
            coefs, y, z_sym = self.enc_front(x)
            shapes = [tuple(c.shape[1:]) for c in coefs]
            dt = torch.int8 if _coef_fit_int8(self.model.jpeg_quality) else torch.int16
            flat = torch.cat([c.reshape(c.shape[0], -1).to(dt) for c in coefs], dim=1)
            if r.device_coder is None:
                return ("host", ((y, z_sym, flat), shapes, size, start))
            return ("device", (r._latents_dispatch_device(y, z_sym, extra=flat),
                               shapes, size, start))

    def _compress_finish(self, state) -> Dict:
        """Code (host coder) or frame (device coder) the residual, then
        assemble one JFIF buffer an image."""
        kind, (enc, shapes, size, start) = state
        r = self._residual
        with span("compress.finish"):
            if kind == "host":
                y, z_sym, flat = enc
                out = r._compress_from_latents_host(y, z_sym, size, start)
                vals = _host(flat)
            else:
                out, vals = r._latents_finish_device(enc, size, start)
            with span("jfif.assemble"):
                out["jpeg_buffers"] = assemble_batch(vals, shapes, size[1], size[0],
                                                     self.model.jpeg_quality)
        out["time"] = time.perf_counter() - start
        return out

    # -- decoder ---------------------------------------------------------

    def decompress(self, compressed: Dict) -> Dict:
        """-> {"x_hat" NHWC, "symbols" decoded (z, anchor, non-anchor),
        "time"}."""
        x_hat, symbols, start, done = self._dec_dispatch_from_comp(compressed)
        with span("decompress.wait"):
            wait_event(done)
        return {"x_hat": x_hat, "symbols": symbols,
                "time": time.perf_counter() - start}

    def _dec_dispatch_from_comp(self, compressed: Dict):
        """Async half of decompress: the residual decode stages and
        synthesis, JFIF parse, coefficient upload (sparse when smaller) and
        the tail, returned as (x_hat, symbols, start time, event after the
        tail) without a wait. Under the device coder the parse runs while
        the card works through the decode chain and synthesis queued
        before it."""
        start = time.perf_counter()
        with span("decompress.dispatch"):
            r = self._residual
            r._require_tables()
            y_anchor_hat, n_sym, mn_p, symbols = r._decode_latent_stages(
                compressed["strings"], compressed["shape"])
            res_hat = r.dec_stage3(y_anchor_hat, n_sym, mn_p)
            with span("jfif.parse"):
                planes = [ParsedJpeg(b) for b in compressed["jpeg_buffers"]]
                check_420(planes)
                p0 = planes[0]
                coef_u8, dtype, shapes = coef_bytes(planes)
                coef_u8, sparse_cap = sparse_coef_bytes(coef_u8, dtype)
            # the device path leaves its symbols on the device, its chain queued
            if isinstance(symbols[0], torch.Tensor):
                WIRE_STATS["overlapped_parses"] += 1
            with span("coder.upload"):
                coefs = coefs_from_bytes(upload_bytes(coef_u8, self.device), dtype, shapes,
                                         sparse_cap)
            x_hat = self.dec_final(res_hat, *coefs, p0.qtables[0], p0.qtables[1],
                                   p0.height, p0.width)
            return x_hat, symbols, start, record_event(self.device)

    @torch.inference_mode()
    def decode_jpeg(self, buffers) -> torch.Tensor:
        """The JPEG base layer alone: JFIF buffers -> NHWC [0,1] batch."""
        return decode_jfif(buffers, self.device)

    @torch.inference_mode()
    def dec_final(self, res_hat, cy, ccb, ccr, qy, qc, height: int,
                  width: int) -> torch.Tensor:
        """Decode tail: dequant/IDCT (K2) + the synthesised residual (padded
        NHWC) + refine."""
        with span("model.jpeg"):
            jpeg_decoded = decode_with_qtables(cy, ccb, ccr, qy, qc, height, width)
        with span("model.refine"):
            x_init = jpeg_decoded + res_hat[:, :height, :width, :]
            return self.model.refine_stage(x_init)

    # -- serving -----------------------------------------------------------

    def inference(self, x: torch.Tensor) -> Dict:
        """One timed roundtrip: {"x_hat", "symbols", "compressed", "time"}."""
        comp = self.compress(x)
        dec = self.decompress(comp)
        return {
            "x_hat": dec["x_hat"],
            "symbols": dec["symbols"],
            "compressed": comp,
            "time": {"compression": comp["time"], "decompression": dec["time"],
                     "total": comp["time"] + dec["time"]},
        }

    def inference_stream(self, xs, depth: int = 2) -> List[Dict]:
        """Pipelined roundtrips: ``CodecBase.inference_stream`` on this
        codec's hooks (it composes a residual codec rather than inheriting)."""
        return CodecBase.inference_stream(self, xs, depth)
