"""LightWeightCheckerboard residual codec model.

Counterpart of ``hyres_tpu/models/checkerboard.py``: a hyperprior
autoencoder with a one-shot checkerboard context model (N=128, M=192).
The methods the coder choreography uses (``analysis``, ``synthesis``,
``hyper_synthesis``, ``anchor_params``, ``nonanchor_params``,
``eb_medians``, reference ``:165-192``) take and return NHWC tensors as
the reference's do; the transforms inside run NCHW. ``forward`` is the
training forward (``:192-236``) and ``aux_loss`` the bottleneck's
quantile loss.

Training noise: ``draw_noise`` takes every draw a forward needs from one
``torch.Generator`` (z's, then the anchor's and the non-anchor's y noise
in noise mode), through ``nn/quantizer.py uniform_noise``, before the
forward runs; a checkpointed (rematerialised) forward gets the draws as
tensors and so recomputes with the same noise.

Precision: with ``compute_dtype`` set (bfloat16), g_a/h_a, g_s and h_s
run in it and return float32; the context and aggregation path stays
float32, so scale-table indexes keep full precision.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy import EntropyBottleneck, gaussian_likelihood
from ..nn import (GDN, AttentionBlock, CheckboardMaskedConv, Conv, Deconv,
                  ResidualBottleneckBlock, checkerboard, conv1x1, conv3x3, quantizer)
from ..nn.checkerboard import ANCHOR, NON_ANCHOR


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class _Sequence(nn.Module):
    """Children applied in definition order (flax ``@nn.compact`` order)."""

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x


class AnalysisTransform(_Sequence):
    """g_a: x (3 ch) -> y (M ch) at 1/8 resolution."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.Conv_0 = Conv(3, N)
        self.GDN_0 = GDN(N)
        self.ResidualBottleneckBlock_0 = ResidualBottleneckBlock(N)
        self.AttentionBlock_0 = AttentionBlock(N)
        self.Conv_1 = Conv(N, N)
        self.GDN_1 = GDN(N)
        self.ResidualBottleneckBlock_1 = ResidualBottleneckBlock(N)
        self.Conv_2 = Conv(N, M)
        self.AttentionBlock_1 = AttentionBlock(M)


class SynthesisTransform(_Sequence):
    """g_s: y_hat (M ch) -> residual (3 ch) at 8x resolution."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.AttentionBlock_0 = AttentionBlock(M)
        self.Deconv_0 = Deconv(M, N)
        self.ResidualBottleneckBlock_0 = ResidualBottleneckBlock(N)
        self.GDN_0 = GDN(N, inverse=True)
        self.Deconv_1 = Deconv(N, N)
        self.AttentionBlock_1 = AttentionBlock(N)
        self.ResidualBottleneckBlock_1 = ResidualBottleneckBlock(N)
        self.GDN_1 = GDN(N, inverse=True)
        self.Deconv_2 = Deconv(N, 3)


class HyperAnalysis(nn.Module):
    """h_a: y -> z at 1/4 of y's resolution."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.Conv_0 = conv3x3(M, N)
        self.Conv_1 = Conv(N, N)
        self.Conv_2 = Conv(N, N)

    def forward(self, y):
        y = F.relu(self.Conv_0(y))
        y = F.relu(self.Conv_1(y))
        return self.Conv_2(y)


class HyperSynthesis(nn.Module):
    """h_s: z_hat -> 2M-channel latent params at y's resolution."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.Deconv_0 = Deconv(N, N)
        self.Deconv_1 = Deconv(N, N * 3 // 2)
        self.Conv_0 = conv3x3(N * 3 // 2, 2 * M)

    def forward(self, z):
        z = F.relu(self.Deconv_0(z))
        z = F.relu(self.Deconv_1(z))
        return self.Conv_0(z)


class ParamAggregation(nn.Module):
    """1x1 stack 4M -> 640 -> 512 -> 2M."""

    def __init__(self, M: int):
        super().__init__()
        self.Conv_0 = conv1x1(4 * M, 640)
        self.Conv_1 = conv1x1(640, 512)
        self.Conv_2 = conv1x1(512, 2 * M)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        return self.Conv_2(x)


class LightWeightCheckerboard(nn.Module):
    def __init__(self, N: int = 128, M: int = 192, compute_dtype=None):
        super().__init__()
        self.N, self.M, self.compute_dtype = N, M, compute_dtype
        self.g_a = AnalysisTransform(N, M)
        self.g_s = SynthesisTransform(N, M)
        self.h_a = HyperAnalysis(N, M)
        self.h_s = HyperSynthesis(N, M)
        self.context_prediction = CheckboardMaskedConv(M, 2 * M)
        self.param_aggregation = ParamAggregation(M)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def _cd(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def analysis(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x -> (y, z) NHWC float32."""
        y = self.g_a(self._cd(to_nchw(x)))
        z = self.h_a(y)
        return to_nhwc(y.float()), to_nhwc(z.float())

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.g_s(self._cd(to_nchw(y_hat))).float())

    def hyper_synthesis(self, z_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.h_s(self._cd(to_nchw(z_hat))).float())

    def _split_params(self, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scales, means = to_nhwc(p).chunk(2, dim=-1)
        return scales, means

    def anchor_params(self, latent_params: torch.Tensor):
        lp = to_nchw(latent_params)
        return self._split_params(
            self.param_aggregation(torch.cat([lp, torch.zeros_like(lp)], dim=1)))

    def nonanchor_params(self, latent_params: torch.Tensor, y_anchor_hat: torch.Tensor):
        lp = to_nchw(latent_params)
        ctx = self.context_prediction(to_nchw(y_anchor_hat))
        return self._split_params(self.param_aggregation(torch.cat([lp, ctx], dim=1)))

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    def latent_shapes(self, x_shape) -> Tuple[tuple, tuple]:
        """NHWC shapes of y and z for an NHWC input of ``x_shape``: three
        stride-2 convolutions to y, two more to z (each ceil(n / 2))."""
        B, H, W, _ = x_shape
        h, w = H, W
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        return (B, h, w, self.M), (B, -(-h // 4), -(-w // 4), self.N)

    def draw_noise(self, x_shape, generator: torch.Generator, noisequant: bool,
                   device) -> Dict[str, torch.Tensor]:
        """Every draw of one forward on an input of ``x_shape``, in the
        reference's layouts: z's noise (always, as the reference draws it
        whenever it has a key), then the anchor's and the non-anchor's y
        noise in noise mode."""
        y_shape, z_shape = self.latent_shapes(x_shape)
        out = {"z": quantizer.uniform_noise(
            self.entropy_bottleneck.noise_shape(z_shape), generator, device)}
        if noisequant:
            out["y_anchor"] = quantizer.uniform_noise(y_shape, generator, device)
            out["y_nonanchor"] = quantizer.uniform_noise(y_shape, generator, device)
        return out

    def forward(self, x: torch.Tensor, noisequant: bool = False,
                generator: torch.Generator | None = None,
                noise: Dict[str, torch.Tensor] | None = None,
                remat: bool = False) -> Dict:
        """Training forward on NHWC ``x``: ``{"x_hat", "likelihoods":
        {"y", "z"}}``. Noise comes from ``noise`` (``draw_noise``'s dict) or
        is drawn from ``generator``; with neither, z rounds about the
        medians. ``noisequant`` picks noise (else STE) for y; z's
        likelihood takes the noisy z whenever there is noise, and in STE
        mode z_hat is then ``ste(z - med) + med``, as the reference does.
        ``remat`` recomputes the forward in the backward."""
        if noise is None and generator is not None:
            noise = self.draw_noise(x.shape, generator, noisequant, x.device)
        if noisequant and noise is None:
            raise ValueError("noise quantization needs a generator or noise draws")
        if remat:
            return checkpoint(self._forward, x, noisequant, noise, use_reentrant=False)
        return self._forward(x, noisequant, noise)

    def _forward(self, x: torch.Tensor, noisequant: bool, noise) -> Dict:
        y, z = self.analysis(x)
        H, W = y.shape[1], y.shape[2]

        eb = self.entropy_bottleneck
        z_hat, z_lik = eb(z, noise=noise is not None,
                          u=None if noise is None else noise["z"])
        if not noisequant:
            med = self.eb_medians()
            z_hat = quantizer.ste(z - med) + med

        latent_params = self.hyper_synthesis(z_hat)
        scales_a, means_a = self.anchor_params(latent_params)
        if noisequant:
            y_anchor_hat = quantizer.quantize(y, "noise", noise["y_anchor"])
        else:
            y_anchor_hat = quantizer.ste(y - means_a) + means_a
        y_anchor_hat = checkerboard.split(y_anchor_hat, ANCHOR)

        scales_n, means_n = self.nonanchor_params(latent_params, y_anchor_hat)
        if noisequant:
            y_nonanchor_hat = quantizer.quantize(y, "noise", noise["y_nonanchor"])
        else:
            y_nonanchor_hat = quantizer.ste(y - means_n) + means_n
        y_nonanchor_hat = checkerboard.split(y_nonanchor_hat, NON_ANCHOR)

        x_hat = self.synthesis(y_anchor_hat + y_nonanchor_hat)

        mask_a = checkerboard.parity_mask(H, W, ANCHOR, y.dtype, y.device)
        scales = mask_a * scales_a + (1.0 - mask_a) * scales_n
        means = mask_a * means_a + (1.0 - mask_a) * means_n
        # the reference takes y's likelihood at the unquantised y
        y_lik = gaussian_likelihood(y, scales, means)
        return {"x_hat": x_hat, "likelihoods": {"y": y_lik, "z": z_lik}}
