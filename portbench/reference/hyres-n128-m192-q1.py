"""Plain reference of HyRES (N=128, M=192, JPEG quality 1): a baseline JPEG
base layer, a checkerboard hyperprior codec of the residual, and the
multi-scale refinement CNN, in float32 PyTorch (the DCT in float64).

Serving: ``encode`` gives the JPEG coefficients and the coder symbols of
an image; ``decode`` rebuilds the reconstruction from coefficients and
symbols. Training: ``loss`` is the RD loss of the recipe's noise
quantisation. Weights come from the raw artifact file, read here.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import common as C
from portbench.reference import jpeg as J
from portbench.reference import nets as R
from portbench.reference.msgpack_read import load_artifact


def load_weights(cfg: dict, root, device) -> dict:
    """The artifact's weights as float32 tensors on ``device``."""
    config, params, _ = load_artifact(root / cfg["artifact"])
    if (config["N"], config["M"], config["jpeg_quality"]) != (cfg["N"], cfg["M"], cfg["jpeg_quality"]):
        raise ValueError(f"artifact holds {config}, the configuration states {cfg}")
    flat = {**C.flax_to_torch(params["residual_model"]),
            **C.flax_to_torch(params["refine"], "refine.")}
    return {k: torch.from_numpy(v).to(device) for k, v in flat.items()}


class Reference:
    dct_dtype = torch.float64  # a control in lower precision sets float32

    def __init__(self, cfg: dict, W: dict):
        self.q = int(cfg["jpeg_quality"])
        self.W = W

    def _params(self, lp, ctx):
        """Scales and means (in that order) from the hyper output and a
        context."""
        p = R.conv_stack(self.W, "param_aggregation", torch.cat([lp, ctx], dim=1))
        return p.chunk(2, dim=1)

    def encode(self, x, jpeg=None):
        """NHWC [0, 1] -> {"coefs": (Y, Cb, Cr) int32, "symbols": [z, anchor,
        non-anchor] int16 in the coder's layouts (z NHWC, the y classes
        packed NHWC half planes)}. ``jpeg``: the base layer's (coefficients,
        quant tables) whose decode the residual is taken against, where the
        judged side's base layer is known (else this encode's own)."""
        W = self.W
        coefs = J.encode(x, self.q, self.dct_dtype)
        dec = J.decode(*(jpeg or (coefs, J.qtables(self.q))), x.shape[1], x.shape[2])
        y = R.g_a(W, C.nchw(C.pad_to(x - dec, 64)))
        z = R.h_a(W, y)
        med = R.eb_medians(W)[None, :, None, None]
        z_sym = R.symbols(z, med)
        lp = R.h_s(W, z_sym.float() + med)
        _, ma = self._params(lp, torch.zeros_like(lp))
        a_sym = R.symbols(R.pack(y, C.ANCHOR), R.pack(ma, C.ANCHOR))
        ya = R.unpack(a_sym.float() + R.pack(ma, C.ANCHOR), C.ANCHOR)
        _, mn = self._params(lp, R.masked_conv(W, "context_prediction", ya))
        n_sym = R.symbols(R.pack(y, C.NON_ANCHOR), R.pack(mn, C.NON_ANCHOR))
        return {"coefs": coefs, "symbols": [C.nhwc(z_sym), a_sym, n_sym]}

    def decode(self, syms, height: int, width: int, jpeg):
        """[z, anchor, non-anchor] symbols and the base layer's (coefficients,
        quant tables) -> NHWC reconstruction in [0, 1]."""
        W = self.W
        jpeg = J.decode(*jpeg, height, width)
        med = R.eb_medians(W)[None, :, None, None]
        lp = R.h_s(W, C.nchw(syms[0]).float() + med)
        _, ma = self._params(lp, torch.zeros_like(lp))
        ya = R.unpack(syms[1].float() + R.pack(ma, C.ANCHOR), C.ANCHOR)
        _, mn = self._params(lp, R.masked_conv(W, "context_prediction", ya))
        y_hat = ya + R.unpack(syms[2].float() + R.pack(mn, C.NON_ANCHOR), C.NON_ANCHOR)
        x0 = jpeg + C.nhwc(R.g_s(W, y_hat))[:, :height, :width]
        return torch.clamp(x0 + C.nhwc(R.refine(W, C.nchw(x0))), 0.0, 1.0)

    def loss(self, W, x, noise, lmbda: float):
        """RD loss of one batch (NHWC [0, 1]) under noise quantisation:
        lambda * 255^2 * MSE + the residual codec's bits per pixel (y under
        its checkerboard Gaussian, z under the factorized prior) + the JPEG
        file's bits per pixel (a constant to the weights). ``noise``: U(-0.5,
        0.5) draws ``z`` (C, 1, B*h*w), ``y_anchor`` and ``y_nonanchor``
        (NHWC of y)."""
        B, H, Wd, _ = x.shape
        with torch.no_grad():
            coefs = J.encode(x, self.q, self.dct_dtype)
            dec = J.decode(coefs, J.qtables(self.q), H, Wd)
            jpeg_bpp = torch.mean(J.bpp(coefs, H, Wd))
        y = R.g_a(W, C.nchw(x - dec))
        z = R.h_a(W, y)
        v = R.to_eb(z) + noise["z"]
        z_lik = R.eb_likelihood(W, v)
        lp = R.h_s(W, R.from_eb(v, z.shape))
        p = lambda ctx: R.conv_stack(W, "param_aggregation", torch.cat([lp, ctx], 1)).chunk(2, 1)  # noqa: E731
        sa, ma = p(torch.zeros_like(lp))
        mask = R.parity(y.shape[2], y.shape[3], C.ANCHOR, y.device)
        ya = (y + C.nchw(noise["y_anchor"])) * mask
        sn, mn = p(R.masked_conv(W, "context_prediction", ya))
        yn = (y + C.nchw(noise["y_nonanchor"])) * (1 - mask)
        y_lik = R.gaussian_likelihood(y, mask * sa + (1 - mask) * sn, mask * ma + (1 - mask) * mn)
        x0 = dec + C.nhwc(R.g_s(W, ya + yn))
        x_hat = torch.clamp(x0 + C.nhwc(R.refine(W, C.nchw(x0))), 0.0, 1.0)
        bits = -(torch.sum(torch.log(y_lik)) + torch.sum(torch.log(z_lik))) / math.log(2.0)
        return lmbda * 255.0 ** 2 * torch.mean((x_hat - x) ** 2) + bits / (B * H * Wd) + jpeg_bpp
