"""TCM: learned image compression with mixed Transformer-CNN blocks.

After Liu, Sun and Katto, "Learned Image Compression with Mixed
Transformer-CNN Architectures", CVPR 2023 (arXiv:2303.14978), and its code
LIC_TCM ``models/tcm.py`` (the JAX package has no counterpart). At the
published widths N = 128 (2N = 256 channels in every block) and M = 320:

* g_a: a strided residual block from RGB, then three stages of two
  ``ConvTransBlock``s (W, then SW; head widths 8, 16, 32; windows 8), each
  of the first two followed by a strided residual block and the last by a
  stride-2 3x3 convolution to M: y at 1/16 of the input;
* g_s mirrors it with sub-pixel upsampling blocks (head widths 32, 16, 8)
  and a sub-pixel convolution to RGB;
* h_a: a strided residual block, two blocks (head width 32, windows 4), a
  stride-2 3x3 convolution to 192 channels: z at 1/64; h_mean_s and
  h_scale_s: separate stacks of an upsampling block, two blocks and a
  sub-pixel convolution back to M;
* the slice chain (Minnen and Singh 2020's channel-wise context): y in
  ``SLICES`` (5) slices of M / 5 channels; slice i's means and scales come
  from SWAtten of the hyper parameters with the slices decoded before it
  (at most ``MAX_SUPPORT``), then a 3x3 stack (cin -> 224 -> 128 -> M /
  5, GELUs between); its y_hat, the symbols plus the means, gets
  0.5 tanh of a latent residual prediction (LRP) of the means' support
  and itself.

The coder's methods (``analysis``, ``synthesis``, ``hyper_synthesis``,
``slice_params``, ``slice_refine``) take and return NHWC tensors; the
convolutions inside run NCHW. ``forward`` is the training forward: noise
draws (``draw_noise``) give the likelihoods, the straight-through rounded
latents feed the chain and g_s, as LIC_TCM's. Every layer runs float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy import EntropyBottleneck, gaussian_likelihood
from ..nn import (ResidualBlockUpsample, ResidualBlockWithStride, SubpelConv3x3, conv3x3,
                  quantizer)
from ..nn.swin import ConvTransBlock, SWAtten
from .checkerboard import _Sequence, to_nchw, to_nhwc

# the published structure: g_a's and g_s's head widths by stage, the hyper
# transforms' window and head width, SWAtten's head width, and the slice
# chain's slices and the slices of support each takes at most
HEAD_DIMS = (8, 16, 32, 32, 16, 8)
HYPER_WINDOW, HYPER_HEAD_DIM = 4, 32
SWATTEN_HEAD_DIM = 16
SLICES, MAX_SUPPORT = 5, 5


def _stage(seq: nn.Module, first: int, N: int, head_dim: int, window: int) -> None:
    """Two blocks, W then SW, named ``ConvTransBlock_{first}`` and on."""
    for k in range(2):
        seq.add_module(f"ConvTransBlock_{first + k}",
                       ConvTransBlock(N, head_dim, window, shifted=bool(k)))


class _CC(nn.Module):
    """3x3 stack cin -> 224 -> 128 -> cout with exact GELUs between."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = conv3x3(cin, 224)
        self.Conv_1 = conv3x3(224, 128)
        self.Conv_2 = conv3x3(128, cout)

    def forward(self, x):
        return self.Conv_2(F.gelu(self.Conv_1(F.gelu(self.Conv_0(x)))))


class TCM(nn.Module):
    def __init__(self, N: int = 128, M: int = 320, window: int = 8, z_channels: int = 192,
                 swatten_inter: int = 128):
        super().__init__()
        if M % SLICES:
            raise ValueError(f"M={M} does not split into {SLICES} slices")
        self.N, self.M, self.slices = N, M, SLICES
        self.slice_channels = M // SLICES
        self.g_a = _Sequence()
        self.g_a.add_module("ResidualBlockWithStride_0", ResidualBlockWithStride(3, 2 * N, 2))
        for s in range(3):
            _stage(self.g_a, 2 * s, N, HEAD_DIMS[s], window)
            if s < 2:
                self.g_a.add_module(f"ResidualBlockWithStride_{s + 1}",
                                    ResidualBlockWithStride(2 * N, 2 * N, 2))
        self.g_a.add_module("Conv_0", conv3x3(2 * N, M, stride=2))
        self.g_s = _Sequence()
        self.g_s.add_module("ResidualBlockUpsample_0", ResidualBlockUpsample(M, 2 * N, 2))
        for s in range(3):
            _stage(self.g_s, 2 * s, N, HEAD_DIMS[3 + s], window)
            if s < 2:
                self.g_s.add_module(f"ResidualBlockUpsample_{s + 1}",
                                    ResidualBlockUpsample(2 * N, 2 * N, 2))
        self.g_s.add_module("SubpelConv3x3_0", SubpelConv3x3(2 * N, 3, 2))
        self.h_a = _Sequence()
        self.h_a.add_module("ResidualBlockWithStride_0", ResidualBlockWithStride(M, 2 * N, 2))
        _stage(self.h_a, 0, N, HYPER_HEAD_DIM, HYPER_WINDOW)
        self.h_a.add_module("Conv_0", conv3x3(2 * N, z_channels, stride=2))
        for name in ("h_mean_s", "h_scale_s"):
            h = _Sequence()
            h.add_module("ResidualBlockUpsample_0", ResidualBlockUpsample(z_channels, 2 * N, 2))
            _stage(h, 0, N, HYPER_HEAD_DIM, HYPER_WINDOW)
            h.add_module("SubpelConv3x3_0", SubpelConv3x3(2 * N, M, 2))
            self.add_module(name, h)
        sc = self.slice_channels
        for i in range(SLICES):
            cin = M + sc * min(i, MAX_SUPPORT)
            for kind in ("mean", "scale"):
                self.add_module(f"atten_{kind}_{i}",
                                SWAtten(cin, SWATTEN_HEAD_DIM, window, swatten_inter))
                self.add_module(f"cc_{kind}_{i}", _CC(cin, sc))
            self.add_module(f"lrp_{i}", _CC(cin + sc, sc))
        self.entropy_bottleneck = EntropyBottleneck(z_channels)

    # -- stages (shared with the coder) -------------------------------------

    def analysis(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x -> (y, z) NHWC."""
        y = self.g_a(to_nchw(x))
        return to_nhwc(y), to_nhwc(self.h_a(y))

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        return to_nhwc(self.g_s(to_nchw(y_hat)))

    def hyper_synthesis(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC z_hat -> (latent means, latent scales) NHWC."""
        z = to_nchw(z_hat)
        return to_nhwc(self.h_mean_s(z)), to_nhwc(self.h_scale_s(z))

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def slice_params(self, i: int, latent_means, latent_scales, y_hat: List[torch.Tensor]):
        """Slice i's (mean support NCHW, means NHWC, scales NHWC) from the
        hyper parameters and the slices decoded before it (NHWC)."""
        support = y_hat[:MAX_SUPPORT]
        ms = getattr(self, f"atten_mean_{i}")(to_nchw(torch.cat([latent_means, *support], -1)))
        ss = getattr(self, f"atten_scale_{i}")(to_nchw(torch.cat([latent_scales, *support], -1)))
        mu = to_nhwc(getattr(self, f"cc_mean_{i}")(ms))
        sigma = to_nhwc(getattr(self, f"cc_scale_{i}")(ss))
        return ms, mu, sigma

    def slice_refine(self, i: int, mean_support: torch.Tensor, y_hat: torch.Tensor):
        """y_hat + 0.5 tanh(LRP(mean support, y_hat)), NHWC y_hat."""
        lrp = getattr(self, f"lrp_{i}")(torch.cat([mean_support, to_nchw(y_hat)], dim=1))
        return y_hat + 0.5 * torch.tanh(to_nhwc(lrp))

    # -- training forward ---------------------------------------------------

    def latent_shapes(self, x_shape) -> Tuple[tuple, tuple]:
        """NHWC shapes of y and z for an NHWC input of ``x_shape``."""
        B, H, W, _ = x_shape
        h, w = H, W
        for _ in range(4):
            h, w = -(-h // 2), -(-w // 2)
        zc = self.entropy_bottleneck.quantiles.shape[0]
        return (B, h, w, self.M), (B, -(-h // 4), -(-w // 4), zc)

    def draw_noise(self, x_shape, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """Every draw of a noise forward: z's, then each slice's ``y_i``."""
        y_shape, z_shape = self.latent_shapes(x_shape)
        out = {"z": quantizer.uniform_noise(
            self.entropy_bottleneck.noise_shape(z_shape), generator, device)}
        for i in range(self.slices):
            out[f"y_{i}"] = quantizer.uniform_noise(y_shape[:3] + (self.slice_channels,),
                                                    generator, device)
        return out

    def forward(self, x: torch.Tensor, noise: Dict[str, torch.Tensor] | None = None) -> Dict:
        """NHWC x -> ``{"x_hat", "likelihoods": {"y", "z"}}``. With ``noise``
        (``draw_noise``'s dict) the likelihoods are of the noisy latents;
        without it, of the rounded ones. The chain and g_s take the
        straight-through rounded latents either way."""
        y, z = self.analysis(x)
        _, z_lik = self.entropy_bottleneck(z, noise=noise is not None,
                                           u=None if noise is None else noise["z"])
        med = self.eb_medians()
        means, scales = self.hyper_synthesis(quantizer.ste(z - med) + med)
        y_hat: List[torch.Tensor] = []
        liks = []
        for i, y_i in enumerate(torch.split(y, self.slice_channels, dim=-1)):
            ms, mu, sigma = self.slice_params(i, means, scales, y_hat)
            q = quantizer.ste(y_i - mu) + mu
            liks.append(gaussian_likelihood(q if noise is None else y_i + noise[f"y_{i}"],
                                            sigma, mu))
            y_hat.append(self.slice_refine(i, ms, q))
        return {"x_hat": self.synthesis(torch.cat(y_hat, dim=-1)),
                "likelihoods": {"y": torch.cat(liks, dim=-1), "z": z_lik}}
