"""HyRES composite codec: JPEG base layer + neural residual + refinement.

Counterpart of ``hyres_tpu/models/hyres.py``: ``ResidualJPEGCompression``
(the training forward with the JPEG base layer under no gradient,
``:75-105``, ``refine_stage`` and ``aux_loss``) and ``HyresCodec`` with
the host or the device rANS coder (``enc_front``, ``dec_final``,
reference ``:108-356``), which serves through ``models/base.py
CodecBase``'s protocol on its residual's checkerboard stages and extends
it at three hooks:

  compress:   ``_front``: JPEG coefficients (K1) -> JPEG decode (K2) ->
              residual -> g_a/h_a; then the checkerboard chain, rANS (host,
              or K3 on the card) and, after framing, ``_assemble``: the
              JFIF bytes
  decompress: the residual's decode chain (host rANS, or K5/K4 on the
              card) -> its synthesis; then ``_tail``: JFIF parse ->
              coefficient upload -> dequant/IDCT (K2) -> refinement

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

from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy import quantize_symbols_i16
from ..jpeg import (ParsedJpeg, decode_from_coefficients, decode_jfif, decode_with_qtables,
                    encode_to_coefficients, jpeg_roundtrip)
from ..jpeg.bitstream import assemble_batch, check_420, coef_bytes
from ..jpeg.core import coefs_from_bytes, pad_to_multiple
from ..jpeg.tables import quality_to_qtables
from ..nn import MultiScaleRefine
from ..utils.trace import span
from .base import CodecBase
from .checkerboard import LightWeightCheckerboard, to_nchw, to_nhwc
from .codec import _COEF_BUCKET, WIRE_STATS, CheckerboardCodec, _bucket, upload_bytes


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


class HyresCodec(CodecBase):
    """Deployment wrapper: real JPEG buffers + residual strings.

    ``compress`` returns the residual codec's dict plus ``jpeg_buffers``;
    ``decompress`` takes that dict and returns ``{"x_hat", "symbols",
    "time"}``. coder: "host" or "device" (see ``CodecBase``). The
    residual's stages are ``_residual``'s, a ``CheckerboardCodec`` on the
    signed residual.
    """

    def __init__(self, model: ResidualJPEGCompression, coder: str = "host",
                 device="cuda"):
        self._residual = CheckerboardCodec(model.residual_model, clamp=None,
                                           coder=coder, device=device)
        super().__init__(model, clamp=None, coder=coder, device=device)

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

    def _eb_param_dict(self) -> dict:
        return self.model.residual_model.entropy_bottleneck.param_dict()

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

    def _front(self, x: torch.Tensor):
        """The JPEG front (one K1 launch, K2 once for the JPEG decode) and
        the residual's analysis; the coefficients ride the pull as its
        extra, int8 when the quality bounds them."""
        coefs, y, z_sym = self.enc_front(x)
        dt = torch.int8 if _coef_fit_int8(self.model.jpeg_quality) else torch.int16
        flat = torch.cat([c.reshape(c.shape[0], -1).to(dt) for c in coefs], dim=1)
        return y, z_sym, flat, [tuple(c.shape[1:]) for c in coefs]

    def _chain(self, z_sym, code, y=None):
        r = self._residual
        lp, a_idx, ma_p, a_sym = r.dec_stage1(z_sym, y)
        y_anchor_hat, n_idx, mn_p, n_sym = r.dec_stage2(lp, code(a_idx, a_sym), ma_p, y)
        return y_anchor_hat, code(n_idx, n_sym), mn_p

    def _y_planes(self, shape):
        return [(4 * shape[0], 2 * shape[1], self.model.M)] * 2  # packed half-width

    def _assemble(self, out: Dict, coefs: np.ndarray, shapes) -> None:
        """One JFIF buffer an image from the coefficients."""
        height, width = out["size"]
        with span("jfif.assemble"):
            out["jpeg_buffers"] = assemble_batch(coefs, shapes, width, height,
                                                 self.model.jpeg_quality)

    # -- decoder ---------------------------------------------------------

    def decompress(self, compressed: Dict) -> Dict:
        """-> {"x_hat" NHWC, "symbols" decoded (z, anchor, non-anchor),
        "time"}."""
        return self._wait(self._dec_dispatch_from_comp(compressed))

    def _synthesis(self, chained) -> torch.Tensor:
        return self._residual.dec_stage3(*chained)

    def _tail(self, res_hat: torch.Tensor, comp: Dict, queued: bool) -> torch.Tensor:
        """JFIF parse, coefficient upload (sparse when smaller) and the
        decode tail. Under the device coder the parse runs while the card
        works through the decode chain and synthesis queued before it."""
        with span("jfif.parse"):
            planes = [ParsedJpeg(b) for b in comp["jpeg_buffers"]]
            check_420(planes)
            p0 = planes[0]
            coef_u8, dtype, shapes = coef_bytes(planes)
            coef_u8, sparse_cap = sparse_coef_bytes(coef_u8, dtype)
        if queued:
            WIRE_STATS["overlapped_parses"] += 1
        with span("coder.upload"):
            coefs = coefs_from_bytes(upload_bytes(coef_u8, self.device), dtype, shapes,
                                     sparse_cap)
        return self.dec_final(res_hat, *coefs, p0.qtables[0], p0.qtables[1],
                              p0.height, p0.width)

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
