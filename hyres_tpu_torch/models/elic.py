"""LightWeightELIC: channel slices with a checkerboard context per slice.

Counterpart of ``hyres_tpu/models/elic.py``: N=192, M=320 and five
channel slices ``groups = (16, 16, 32, 64, 192)`` over the checkerboard
model's g_a/g_s/h_a/h_s (``models/checkerboard.py``), with per-slice
channel-context transforms (``ChannelContext``, from slice 0 and the
slice before), checkerboard context convolutions and parameter
aggregation stacks (``SliceParamAggregation``).

The methods the coder uses (``analysis``, ``synthesis``,
``hyper_synthesis``, ``slice_support``, ``slice_anchor_params``,
``slice_nonanchor_params``, reference ``:124-156``) take and return NHWC
tensors; the convolutions inside run NCHW. Parameters come in the
order (means, scales), the opposite of the checkerboard model's.

Training (``forward``, reference ``:158-232``): each slice codes its
anchor class, then its non-anchor class with the anchor as context. In
noise mode it runs two paths: the noisy latents give the rate, feed the
slice's non-anchor context and the later slices' channel context, and
the straight-through rounded latents feed g_s. ``draw_noise`` takes
every draw of a forward from one generator, in the order z, then per
slice the anchor's and the non-anchor's.

Precision: ``compute_dtype`` (bf16) covers the transform stacks only; the
slice context, aggregation and entropy models stay float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy import EntropyBottleneck, gaussian_likelihood
from ..nn import CheckboardMaskedConv, Conv, checkerboard, conv1x1, quantizer
from ..nn.checkerboard import ANCHOR, NON_ANCHOR
from .checkerboard import (AnalysisTransform, HyperAnalysis, HyperSynthesis,
                           SynthesisTransform, to_nchw, to_nhwc)

GROUPS = (16, 16, 32, 64, 192)


class ChannelContext(nn.Module):
    """Three 5x5 stride-1 convolutions: cin -> 224 -> 128 -> cout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv(cin, 224, kernel=5, stride=1)
        self.Conv_1 = Conv(224, 128, kernel=5, stride=1)
        self.Conv_2 = Conv(128, cout, kernel=5, stride=1)

    def forward(self, x):
        return self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x)))))


class SliceParamAggregation(nn.Module):
    """1x1 stack cin -> 640 -> 512 -> cout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = conv1x1(cin, 640)
        self.Conv_1 = conv1x1(640, 512)
        self.Conv_2 = conv1x1(512, cout)

    def forward(self, x):
        return self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x)))))


class LightWeightELIC(nn.Module):
    def __init__(self, N: int = 192, M: int = 320, groups: Sequence[int] = GROUPS,
                 compute_dtype=None):
        super().__init__()
        groups = tuple(int(g) for g in groups)
        if sum(groups) != M:
            raise ValueError(f"groups {groups} must sum to M={M}")
        self.N, self.M, self.groups, self.compute_dtype = N, M, groups, compute_dtype
        self.g_a = AnalysisTransform(N, M)
        self.g_s = SynthesisTransform(N, M)
        self.h_a = HyperAnalysis(N, M)
        self.h_s = HyperSynthesis(N, M)
        self.entropy_bottleneck = EntropyBottleneck(N)
        # cc_transforms_{i-1} gives slice i's (mean, scale) channel context
        # from slice 0 (and, from slice 2 on, the slice before)
        for i in range(1, len(groups)):
            cin = groups[0] + (groups[i - 1] if i > 1 else 0)
            self.add_module(f"cc_transforms_{i - 1}", ChannelContext(cin, 2 * groups[i]))
        for i, g in enumerate(groups):
            self.add_module(f"context_prediction_{i}", CheckboardMaskedConv(g, 2 * g))
        for i, g in enumerate(groups):
            support = 2 * M + (2 * g if i else 0)
            self.add_module(f"param_aggregation_{i}",
                            SliceParamAggregation(2 * g + support, 2 * g))

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

    def hyper_synthesis(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC z_hat -> (latent means, latent scales) NHWC float32."""
        lp = to_nhwc(self.h_s(self._cd(to_nchw(z_hat))).float())
        means, scales = lp.chunk(2, dim=-1)
        return means, scales

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    def slice_support(self, i: int, y_hat_first, y_hat_prev, latent_means,
                      latent_scales) -> torch.Tensor:
        """Slice i's support (NHWC): the hyper parameters, after the channel
        context of slice 0 and slice i-1 for i > 0."""
        if i == 0:
            return torch.cat([latent_means, latent_scales], dim=-1)
        cc_in = y_hat_first if i == 1 else torch.cat([y_hat_first, y_hat_prev], dim=-1)
        cc = to_nhwc(getattr(self, f"cc_transforms_{i - 1}")(to_nchw(cc_in)))
        cc_mean, cc_scale = cc.chunk(2, dim=-1)
        return torch.cat([cc_mean, cc_scale, latent_means, latent_scales], dim=-1)

    def _aggregate(self, i: int, ctx_nchw: torch.Tensor, support: torch.Tensor):
        p = getattr(self, f"param_aggregation_{i}")(
            torch.cat([ctx_nchw, to_nchw(support)], dim=1))
        means, scales = to_nhwc(p).chunk(2, dim=-1)
        return means, scales

    def slice_anchor_params(self, i: int, support: torch.Tensor):
        """(means, scales) of slice i's anchor class: zero context."""
        B, H, W, _ = support.shape
        zeros = support.new_zeros((B, 2 * self.groups[i], H, W))
        return self._aggregate(i, zeros, support)

    def slice_nonanchor_params(self, i: int, support: torch.Tensor,
                               y_anchor_hat: torch.Tensor):
        """(means, scales) of slice i's non-anchor class, from its anchor."""
        ctx = getattr(self, f"context_prediction_{i}")(to_nchw(y_anchor_hat))
        return self._aggregate(i, ctx, support)

    # -- training forward ---------------------------------------------------

    def latent_shapes(self, x_shape) -> Tuple[tuple, tuple]:
        """NHWC shapes of y and z for an NHWC input of ``x_shape``."""
        B, H, W, _ = x_shape
        h, w = H, W
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        return (B, h, w, self.M), (B, -(-h // 4), -(-w // 4), self.N)

    def draw_noise(self, x_shape, generator: torch.Generator, noisequant: bool,
                   device) -> Dict[str, torch.Tensor]:
        """Every draw of one forward on an input of ``x_shape``: z's noise,
        then in noise mode per slice i the anchor's (``y_anchor_i``) and
        the non-anchor's (``y_nonanchor_i``), each of the slice's shape."""
        y_shape, z_shape = self.latent_shapes(x_shape)
        out = {"z": quantizer.uniform_noise(
            self.entropy_bottleneck.noise_shape(z_shape), generator, device)}
        if noisequant:
            for i, g in enumerate(self.groups):
                shape = y_shape[:3] + (g,)
                out[f"y_anchor_{i}"] = quantizer.uniform_noise(shape, generator, device)
                out[f"y_nonanchor_{i}"] = quantizer.uniform_noise(shape, generator, device)
        return out

    def forward(self, x: torch.Tensor, noisequant: bool = False,
                generator: torch.Generator | None = None,
                noise: Dict[str, torch.Tensor] | None = None,
                remat: bool = False) -> Dict:
        """Training forward on NHWC ``x``: ``{"x_hat", "likelihoods": {"y",
        "z"}}``, with the checkerboard model's contract for ``noise``,
        ``generator``, ``noisequant`` and ``remat``."""
        if noise is None and generator is not None:
            noise = self.draw_noise(x.shape, generator, noisequant, x.device)
        if noisequant and noise is None:
            raise ValueError("noise quantization needs a generator or noise draws")
        if remat:
            return checkpoint(self._forward, x, noisequant, noise, use_reentrant=False)
        return self._forward(x, noisequant, noise)

    def _process_slice(self, i: int, y_slice, support, noisequant: bool, noise):
        """-> (y_hat for the context, y_hat for g_s, likelihoods)."""
        H, W = y_slice.shape[1], y_slice.shape[2]
        means_a, scales_a = self.slice_anchor_params(i, support)
        y_anchor = checkerboard.split(y_slice, ANCHOR)
        if noisequant:
            y_anchor_q = quantizer.quantize(y_anchor, "noise", noise[f"y_anchor_{i}"])
            y_anchor_q_gs = quantizer.ste(y_anchor)
        else:
            y_anchor_q = quantizer.ste(y_anchor - means_a) + means_a
            y_anchor_q_gs = y_anchor_q
        y_anchor_q = checkerboard.split(y_anchor_q, ANCHOR)
        y_anchor_q_gs = checkerboard.split(y_anchor_q_gs, ANCHOR)

        means_n, scales_n = self.slice_nonanchor_params(i, support, y_anchor_q)
        mask_a = checkerboard.parity_mask(H, W, ANCHOR, y_slice.dtype, y_slice.device)
        scales_hat = mask_a * scales_a + (1 - mask_a) * scales_n
        means_hat = mask_a * means_a + (1 - mask_a) * means_n
        lik = gaussian_likelihood(y_slice, scales_hat, means_hat)

        y_non = checkerboard.split(y_slice, NON_ANCHOR)
        if noisequant:
            y_non_q = quantizer.quantize(y_non, "noise", noise[f"y_nonanchor_{i}"])
            y_non_q_gs = quantizer.ste(y_non)
        else:
            y_non_q = quantizer.ste(y_non - means_n) + means_n
            y_non_q_gs = y_non_q
        y_non_q = checkerboard.split(y_non_q, NON_ANCHOR)
        y_non_q_gs = checkerboard.split(y_non_q_gs, NON_ANCHOR)
        return y_anchor_q + y_non_q, y_anchor_q_gs + y_non_q_gs, lik

    def _forward(self, x: torch.Tensor, noisequant: bool, noise) -> Dict:
        y, z = self.analysis(x)
        z_hat, z_lik = self.entropy_bottleneck(
            z, noise=noise is not None, u=None if noise is None else noise["z"])
        if not noisequant:
            med = self.eb_medians()
            z_hat = quantizer.ste(z - med) + med
        latent_means, latent_scales = self.hyper_synthesis(z_hat)

        y_hat_slices: List[torch.Tensor] = []
        y_hat_gs: List[torch.Tensor] = []
        liks: List[torch.Tensor] = []
        for i, y_slice in enumerate(torch.split(y, self.groups, dim=-1)):
            support = self.slice_support(
                i, y_hat_slices[0] if y_hat_slices else None,
                y_hat_slices[-1] if y_hat_slices else None,
                latent_means, latent_scales)
            y_hat, y_hat_for_gs, lik = self._process_slice(
                i, y_slice, support, noisequant, noise)
            y_hat_slices.append(y_hat)
            y_hat_gs.append(y_hat_for_gs)
            liks.append(lik)

        x_hat = self.synthesis(torch.cat(y_hat_gs, dim=-1))
        return {"x_hat": x_hat,
                "likelihoods": {"y": torch.cat(liks, dim=-1), "z": z_lik}}
