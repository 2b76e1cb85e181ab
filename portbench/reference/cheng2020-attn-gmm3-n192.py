"""Plain reference of Cheng2020 with attention and a discretized Gaussian
mixture (Cheng et al., CVPR 2020, arXiv:2001.01568) at N = M = 192, K = 3,
with He et al.'s checkerboard context (arXiv:2103.15306) in place of the
serial one, in float32 PyTorch.

The transforms are CompressAI's ``cheng2020-attn`` layout: residual blocks
with strided and sub-pixel convolutions, GDN, and attention blocks after
g_a's second strided block and at its end, at g_s's start and after its
second upsampling block. The hyperprior's h_s gives the parameters of
both passes; the class coded first (the anchor) is (i + j) odd, the
context a 5x5 convolution of the anchors. The entropy parameters are 3 K M
channels: K blocks of M logits, then of means, then of scales; an element
codes under p(q) = sum_k w_k [Phi((q + 1/2 - mu_k) / s_k) - Phi((q - 1/2 -
mu_k) / s_k)], w = softmax(logits), s_k >= 0.11. The symbols are round(y)
and y_hat is the symbols.

``encode`` gives the coder symbols of an image, ``decode`` the
reconstruction from symbols, ``ideal_bits`` the code length of a
request's y symbols under the float64 mixture, and ``forward`` the two
training forwards (noise and straight-through). Weights are handed in
(the benchmark makes them from the configuration's seed).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.reference import nets as R

ANCHOR, NON_ANCHOR = 1, 0  # Cheng2020's anchor is the (i + j) odd class


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _conv(W, name, x, stride=1):
    return R.conv_s(W, name, x, stride)


def _subpel(W, name, x):
    return F.pixel_shuffle(_conv(W, name + ".Conv_0", x), 2)


def res_block(W, name, x):
    h = _lrelu(_conv(W, name + ".Conv_1", _lrelu(_conv(W, name + ".Conv_0", x))))
    return (_conv(W, name + ".Conv_2", x) if name + ".Conv_2.Conv_0.weight" in W else x) + h


def res_block_stride(W, name, x):
    h = _lrelu(_conv(W, name + ".Conv_0", x, 2))
    h = R.gdn(W, name + ".GDN_0", _conv(W, name + ".Conv_1", h))
    return _conv(W, name + ".Conv_2", x, 2) + h


def res_block_up(W, name, x):
    h = _conv(W, name + ".Conv_0", _lrelu(_subpel(W, name + ".SubpelConv3x3_0", x)))
    return _subpel(W, name + ".SubpelConv3x3_1", x) + R.gdn(W, name + ".GDN_0", h, inverse=True)


def g_a(W, x):
    x = res_block(W, "g_a.ResidualBlock_0", res_block_stride(W, "g_a.ResidualBlockWithStride_0", x))
    x = R.attention_block(W, "g_a.AttentionBlock_0",
                          res_block_stride(W, "g_a.ResidualBlockWithStride_1", x))
    x = res_block(W, "g_a.ResidualBlock_1", x)
    x = res_block(W, "g_a.ResidualBlock_2", res_block_stride(W, "g_a.ResidualBlockWithStride_2", x))
    return R.attention_block(W, "g_a.AttentionBlock_1", _conv(W, "g_a.Conv_0", x, 2))


def g_s(W, y):
    x = R.attention_block(W, "g_s.AttentionBlock_0", y)
    x = res_block_up(W, "g_s.ResidualBlockUpsample_0", res_block(W, "g_s.ResidualBlock_0", x))
    x = res_block_up(W, "g_s.ResidualBlockUpsample_1", res_block(W, "g_s.ResidualBlock_1", x))
    x = R.attention_block(W, "g_s.AttentionBlock_1", x)
    x = res_block_up(W, "g_s.ResidualBlockUpsample_2", res_block(W, "g_s.ResidualBlock_2", x))
    return _subpel(W, "g_s.SubpelConv3x3_0", res_block(W, "g_s.ResidualBlock_3", x))


def h_a(W, y):
    for i, s in enumerate((1, 1, 2, 1)):
        y = _lrelu(_conv(W, f"h_a.Conv_{i}", y, s))
    return _conv(W, "h_a.Conv_4", y, 2)


def h_s(W, z):
    z = _lrelu(_conv(W, "h_s.Conv_0", z))
    z = _lrelu(_subpel(W, "h_s.SubpelConv3x3_0", z))
    z = _lrelu(_conv(W, "h_s.Conv_1", z))
    z = _lrelu(_subpel(W, "h_s.SubpelConv3x3_1", z))
    return _conv(W, "h_s.Conv_2", z)


def entropy_parameters(W, ctx, hyper):
    x = _lrelu(_conv(W, "entropy_parameters.Conv_0", torch.cat([ctx, hyper], dim=1)))
    x = _lrelu(_conv(W, "entropy_parameters.Conv_1", x))
    return _conv(W, "entropy_parameters.Conv_2", x)


def split(p, K):
    """(..., 3 K M) channels last -> (logits, means, scales), each (..., K, M)."""
    return p.unflatten(-1, (3, K, p.shape[-1] // (3 * K))).unbind(-3)


def mixture_likelihood(y, p, K):
    """P(round(y)) under the mixture in float32, floored as the Gaussian
    likelihood is; y (..., M) and p (..., 3 K M) channels last."""
    logits, means, scales = split(p, K)
    s = R.lower_bound(scales, R.SCALE_BOUND)
    v = torch.abs(y[..., None, :] - means)
    cdf = lambda t: 0.5 * torch.special.erfc(-t * 2 ** -0.5)  # noqa: E731
    q = cdf((0.5 - v) / s) - cdf((-0.5 - v) / s)
    return R.lower_bound((torch.softmax(logits, dim=-2) * q).sum(-2), R.LIKELIHOOD_BOUND)


def mixture_pmf64(p, K, symbols):
    """The float64 probability of integer ``symbols`` (..., M) under the
    mixture of ``p`` (..., 3 K M)."""
    logits, means, scales = (t.double() for t in split(p, K))
    s = torch.clamp(scales, min=R.SCALE_BOUND)
    q = symbols.double()[..., None, :]
    mass = torch.special.ndtr((q + 0.5 - means) / s) - torch.special.ndtr((q - 0.5 - means) / s)
    return (torch.softmax(logits, dim=-2) * mass).sum(-2)


class Reference:
    def __init__(self, cfg: dict, W: dict):
        self.K = int(cfg["mixtures"])
        self.N = int(cfg["N"])
        self.W = W

    def _med(self):
        return R.eb_medians(self.W)[None, :, None, None]

    def params(self, syms):
        """The packed (anchor, non-anchor) entropy parameters, NHWC, from a
        request's symbols [z, anchor, non-anchor]."""
        W = self.W
        hyper = h_s(W, C.nchw(syms[0]).float() + self._med())
        B, _, H, Wd = hyper.shape
        p_a = entropy_parameters(W, hyper.new_zeros((B, 2 * self.N, H, Wd)), hyper)
        ya = R.unpack(syms[1].float(), ANCHOR)
        ctx = R.masked_conv(W, "context_prediction", ya) * R.parity(H, Wd, NON_ANCHOR, ya.device)
        p_n = entropy_parameters(W, ctx, hyper)
        return R.pack(p_a, ANCHOR), R.pack(p_n, NON_ANCHOR)

    def encode(self, x, jpeg=None):
        """NHWC [0, 1] -> {"symbols": [z NHWC, anchor, non-anchor] int16, the
        y classes packed NHWC half planes}."""
        W = self.W
        y = g_a(W, C.nchw(C.pad_to(x, 64)))
        z_sym = C.nhwc(R.symbols(h_a(W, y), self._med()))
        return {"symbols": [z_sym] + [R.symbols(R.pack(y, p), 0.0) for p in (ANCHOR, NON_ANCHOR)]}

    def decode(self, syms, height: int, width: int, jpeg=None):
        y_hat = R.unpack(syms[1].float(), ANCHOR) + R.unpack(syms[2].float(), NON_ANCHOR)
        x = C.nhwc(g_s(self.W, y_hat))[:, :height, :width]
        return torch.clamp(x, 0.0, 1.0)

    def ideal_bits(self, syms) -> float:
        """-sum log2 p of the y symbols under the float64 mixture, each p
        floored at 2^-64."""
        bits = 0.0
        for p, s in zip(self.params(syms), syms[1:]):
            pmf = mixture_pmf64(p, self.K, s.to(p.device))
            bits += float(-torch.log2(pmf.clamp(min=2.0 ** -64)).sum())
        return bits

    def forward(self, x, noise=None):
        """The training forward on NHWC x: with ``noise`` (``{"z": (C, 1,
        B H W), "y": NHWC}``) the noise pass, without it the
        straight-through two-pass path. -> (x_hat NHWC, y likelihoods NHWC,
        z likelihoods NHWC)."""
        W = self.W
        y = g_a(W, C.nchw(x))
        z = h_a(W, y)
        v = R.to_eb(z)
        if noise is not None:
            v = v + noise["z"]
        else:
            med = R.eb_medians(W)[:, None, None]
            v = torch.round(v - med) + med
        z_lik = R.from_eb(R.eb_likelihood(W, v), z.shape)
        hyper = h_s(W, R.from_eb(v, z.shape))
        B, _, H, Wd = y.shape
        non = R.parity(H, Wd, NON_ANCHOR, y.device)
        if noise is not None:
            y_hat = y + C.nchw(noise["y"])
            p = entropy_parameters(W, R.masked_conv(W, "context_prediction", y_hat) * non, hyper)
        else:
            y_hat = torch.round(y)
            p_a = entropy_parameters(W, y.new_zeros((B, 2 * self.N, H, Wd)), hyper)
            ctx = R.masked_conv(W, "context_prediction", y_hat * (1 - non)) * non
            p = (1 - non) * p_a + non * entropy_parameters(W, ctx, hyper)
        y_lik = mixture_likelihood(C.nhwc(y), C.nhwc(p), self.K)
        return C.nhwc(g_s(W, y_hat)), y_lik, C.nhwc(z_lik)
