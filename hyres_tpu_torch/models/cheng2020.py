"""Cheng2020-anchor with a checkerboard context.

Counterpart of ``hyres_tpu/models/cheng2020.py``: residual-block
transforms with sub-pixel upsampling (N = M = 192, y at 1/16 of the
input, z at 1/64), a one-shot checkerboard context and a 1x1
entropy-parameter stack 4N -> 10N/3 -> 8N/3 -> 2N.

Parity: this family calls the (i + j) ODD class its anchor, the opposite
of the checkerboard and ELIC models: ``CHENG_ANCHOR`` is
``nn.checkerboard.NON_ANCHOR`` and is coded first, without context.
``entropy_params`` returns (scales, means).

Training: ``forward`` in noise mode is the reference's single pass
(``_forward_train``, ``:187-202``): noisy z and y, the context of the
noisy y kept only at the non-anchor positions. In STE mode it is the
two-pass path that matches the decoder (``_validate``, ``:204-230``),
which takes no noise at all, z included. ``draw_noise`` draws z's and
then y's noise in noise mode and nothing in STE mode.

Variants (beyond the reference): ``attention=True`` puts CompressAI's
``cheng2020-attn`` attention blocks into the transforms (after g_a's
second strided block and at its end; at g_s's start and after its second
upsampling block); ``mixtures=K > 1`` is the paper's discretized Gaussian
mixture (arXiv:2001.01568): the last 1x1 of the entropy parameters gives
3 K M channels, K blocks of M logits, then of means, then of scales
(``mixture_params``; ``entropy/mixture.py``), and both forwards return
``gmm_likelihood`` of y. The defaults are the reference's model.

Precision: ``compute_dtype`` (bf16) covers g_a/h_a, g_s and h_s; the
context and entropy-parameter path stays float32. The methods set no
cuDNN flags: ``Cheng2020Codec`` picks the algorithms of each stage.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy import EntropyBottleneck, gaussian_likelihood
from ..entropy.mixture import gmm_likelihood, split_params
from ..nn import (AttentionBlock, CheckboardMaskedConv, ResidualBlock,
                  ResidualBlockUpsample, ResidualBlockWithStride, SubpelConv3x3,
                  checkerboard, conv1x1, conv3x3, quantizer)
from ..nn.checkerboard import ANCHOR, NON_ANCHOR
from .checkerboard import _Sequence, to_nchw, to_nhwc

# the cheng anchor is the odd parity class (coded first, no context)
CHENG_ANCHOR = NON_ANCHOR
CHENG_NONANCHOR = ANCHOR


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)  # flax's slope


class _GA(_Sequence):
    """Analysis: three strided residual blocks, each followed by a residual
    block, then a stride-2 3x3 convolution; with ``attention``, attention
    blocks after the second strided block and at the end."""

    def __init__(self, N: int, attention: bool = False):
        super().__init__()
        for i in range(3):
            self.add_module(f"ResidualBlockWithStride_{i}",
                            ResidualBlockWithStride(3 if i == 0 else N, N, 2))
            if attention and i == 1:
                self.AttentionBlock_0 = AttentionBlock(N)
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(N, N))
        self.Conv_0 = conv3x3(N, N, stride=2)
        if attention:
            self.AttentionBlock_1 = AttentionBlock(N)


class _GS(_Sequence):
    """Synthesis: residual blocks with sub-pixel upsampling, to RGB; with
    ``attention``, attention blocks first and after the second upsampling."""

    def __init__(self, N: int, attention: bool = False):
        super().__init__()
        if attention:
            self.AttentionBlock_0 = AttentionBlock(N)
        for i in range(3):
            self.add_module(f"ResidualBlock_{i}", ResidualBlock(N, N))
            self.add_module(f"ResidualBlockUpsample_{i}", ResidualBlockUpsample(N, N))
            if attention and i == 1:
                self.AttentionBlock_1 = AttentionBlock(N)
        self.ResidualBlock_3 = ResidualBlock(N, N)
        self.SubpelConv3x3_0 = SubpelConv3x3(N, 3)


class _HA(nn.Module):
    def __init__(self, N: int):
        super().__init__()
        self.Conv_0 = conv3x3(N, N)
        self.Conv_1 = conv3x3(N, N)
        self.Conv_2 = conv3x3(N, N, stride=2)
        self.Conv_3 = conv3x3(N, N)
        self.Conv_4 = conv3x3(N, N, stride=2)

    def forward(self, y):
        for i in range(4):
            y = _leaky_relu(getattr(self, f"Conv_{i}")(y))
        return self.Conv_4(y)


class _HS(nn.Module):
    def __init__(self, N: int):
        super().__init__()
        self.Conv_0 = conv3x3(N, N)
        self.SubpelConv3x3_0 = SubpelConv3x3(N, N)
        self.Conv_1 = conv3x3(N, N * 3 // 2)
        self.SubpelConv3x3_1 = SubpelConv3x3(N * 3 // 2, N * 3 // 2)
        self.Conv_2 = conv3x3(N * 3 // 2, N * 2)

    def forward(self, z):
        z = _leaky_relu(self.Conv_0(z))
        z = _leaky_relu(self.SubpelConv3x3_0(z))
        z = _leaky_relu(self.Conv_1(z))
        z = _leaky_relu(self.SubpelConv3x3_1(z))
        return self.Conv_2(z)


class _EntropyParams(nn.Module):
    """1x1 stack 4N -> 10N/3 -> 8N/3 -> ``out`` (2N, or 3 K N for a mixture)."""

    def __init__(self, N: int, out: int):
        super().__init__()
        self.Conv_0 = conv1x1(4 * N, N * 10 // 3)
        self.Conv_1 = conv1x1(N * 10 // 3, N * 8 // 3)
        self.Conv_2 = conv1x1(N * 8 // 3, out)

    def forward(self, x):
        x = _leaky_relu(self.Conv_0(x))
        x = _leaky_relu(self.Conv_1(x))
        return self.Conv_2(x)


class Cheng2020withCheckerboard(nn.Module):
    def __init__(self, N: int = 192, compute_dtype=None, attention: bool = False,
                 mixtures: int = 1):
        super().__init__()
        if mixtures < 1:
            raise ValueError(f"mixtures must be at least 1, got {mixtures}")
        self.N, self.M, self.compute_dtype = N, N, compute_dtype
        self.attention, self.mixtures = attention, mixtures
        self.g_a = _GA(N, attention)
        self.g_s = _GS(N, attention)
        self.h_a = _HA(N)
        self.h_s = _HS(N)
        self.entropy_parameters = _EntropyParams(
            N, N * 2 if mixtures == 1 else 3 * mixtures * N)
        self.context_prediction = CheckboardMaskedConv(N, 2 * N)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def _cd(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    # -- stages (shared with the coder) -------------------------------------

    def analysis(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x -> (y, z) NHWC float32."""
        y = self.g_a(self._cd(to_nchw(x)))
        z = self.h_a(y)
        return to_nhwc(y.float()), to_nhwc(z.float())

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.g_s(self._cd(to_nchw(y_hat))).float())

    def hyper_synthesis(self, z_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.h_s(self._cd(to_nchw(z_hat))).float())

    def mixture_params(self, ctx: torch.Tensor, hyper: torch.Tensor) -> torch.Tensor:
        """NHWC context and hyper parameters -> the entropy parameters NHWC:
        (scales, means) halves, or a mixture's 3 K M channels."""
        return to_nhwc(self.entropy_parameters(torch.cat([to_nchw(ctx), to_nchw(hyper)], dim=1)))

    def entropy_params(self, ctx: torch.Tensor, hyper: torch.Tensor):
        """NHWC context and hyper parameters -> (scales, means) NHWC."""
        scales, means = self.mixture_params(ctx, hyper).chunk(2, dim=-1)
        return scales, means

    def y_likelihood(self, y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The likelihood of y under ``mixture_params``'s output."""
        if self.mixtures == 1:
            scales, means = p.chunk(2, dim=-1)
            return gaussian_likelihood(y, scales, means)
        return gmm_likelihood(y, *split_params(p, self.mixtures))

    def context(self, y_anchor_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.context_prediction(to_nchw(y_anchor_hat)))

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    # -- training forward ---------------------------------------------------

    def latent_shapes(self, x_shape) -> Tuple[tuple, tuple]:
        """NHWC shapes of y and z for an NHWC input of ``x_shape``: four
        stride-2 convolutions to y, two more to z."""
        B, H, W, _ = x_shape
        h, w = H, W
        for _ in range(4):
            h, w = -(-h // 2), -(-w // 2)
        return (B, h, w, self.N), (B, -(-h // 4), -(-w // 4), self.N)

    def draw_noise(self, x_shape, generator: torch.Generator, noisequant: bool,
                   device) -> Dict[str, torch.Tensor]:
        """Every draw of one forward: in noise mode z's, then y's; none in
        STE mode, whose forward takes no noise."""
        if not noisequant:
            return {}
        y_shape, z_shape = self.latent_shapes(x_shape)
        return {"z": quantizer.uniform_noise(
                    self.entropy_bottleneck.noise_shape(z_shape), generator, device),
                "y": quantizer.uniform_noise(y_shape, generator, device)}

    def forward(self, x: torch.Tensor, noisequant: bool = False,
                generator: torch.Generator | None = None,
                noise: Dict[str, torch.Tensor] | None = None,
                remat: bool = False) -> Dict:
        """Training forward on NHWC ``x``: ``{"x_hat", "likelihoods": {"y",
        "z"}}``. Noise mode needs ``noise`` (``draw_noise``'s dict) or a
        ``generator``; ``remat`` recomputes the forward in the backward."""
        if noisequant:
            if noise is None and generator is not None:
                noise = self.draw_noise(x.shape, generator, True, x.device)
            if not noise:
                raise ValueError("noise quantization needs a generator or noise draws")
            fn, args = self._forward_train, (x, noise)
        else:
            fn, args = self._validate, (x,)
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _forward_train(self, x: torch.Tensor, noise) -> Dict:
        y, z = self.analysis(x)
        z_hat, z_lik = self.entropy_bottleneck(z, noise=True, u=noise["z"])
        y_hat = quantizer.quantize(y, "noise", noise["y"])
        hyper = self.hyper_synthesis(z_hat)
        H, W = y.shape[1], y.shape[2]
        ctx = self.context(y_hat) * checkerboard.parity_mask(
            H, W, CHENG_NONANCHOR, y.dtype, y.device)
        y_lik = self.y_likelihood(y, self.mixture_params(ctx, hyper))
        return {"x_hat": self.synthesis(y_hat), "likelihoods": {"y": y_lik, "z": z_lik}}

    def _validate(self, x: torch.Tensor) -> Dict:
        y, z = self.analysis(x)
        _, z_lik = self.entropy_bottleneck(z, noise=False)
        med = self.eb_medians()
        z_hat = quantizer.ste(z - med) + med
        hyper = self.hyper_synthesis(z_hat)
        B, H, W, C = y.shape
        zeros_ctx = y.new_zeros((B, H, W, 2 * C))
        if self.mixtures > 1:
            return self._validate_mixture(y, z_lik, hyper, zeros_ctx)
        scales_a, means_a = self.entropy_params(zeros_ctx, hyper)
        mask_a = checkerboard.parity_mask(H, W, CHENG_ANCHOR, y.dtype, y.device)
        means_a = means_a * mask_a
        scales_a = scales_a * mask_a
        y_hat_anchor = (quantizer.ste(y - means_a) + means_a) * mask_a
        ctx = self.context(y_hat_anchor) * (1.0 - mask_a)
        scales, means = self.entropy_params(ctx, hyper)
        scales = mask_a * scales_a + (1.0 - mask_a) * scales
        means = mask_a * means_a + (1.0 - mask_a) * means
        y_hat = quantizer.ste(y - means) + means
        y_lik = gaussian_likelihood(y, scales, means)
        return {"x_hat": self.synthesis(y_hat), "likelihoods": {"y": y_lik, "z": z_lik}}

    def _validate_mixture(self, y, z_lik, hyper, zeros_ctx) -> Dict:
        """The STE path of a mixture: the symbols are round(y) itself, so
        the anchor's context is its rounded y, and y_hat is round(y)."""
        H, W = y.shape[1], y.shape[2]
        mask_a = checkerboard.parity_mask(H, W, CHENG_ANCHOR, y.dtype, y.device)
        p_a = self.mixture_params(zeros_ctx, hyper)
        y_hat = quantizer.ste(y)
        ctx = self.context(y_hat * mask_a) * (1.0 - mask_a)
        p = mask_a * p_a + (1.0 - mask_a) * self.mixture_params(ctx, hyper)
        return {"x_hat": self.synthesis(y_hat),
                "likelihoods": {"y": self.y_likelihood(y, p), "z": z_lik}}
