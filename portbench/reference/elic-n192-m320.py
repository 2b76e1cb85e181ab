"""Plain reference of ELIC (He et al., CVPR 2022, arXiv:2203.10886) at
N=192, M=320 with the uneven channel groups (16, 16, 32, 64, 192): the
hyperprior transforms, then per group a channel context from group 0 and
the group before, and a checkerboard context inside the group, in float32
PyTorch. ``encode`` gives the coder symbols of an image, ``decode`` the
reconstruction from symbols. Weights are handed in (the benchmark makes
them from the configuration's seed)."""

from __future__ import annotations

import torch

from portbench.reference import common as C
from portbench.reference import nets as R


class Reference:
    def __init__(self, cfg: dict, W: dict):
        self.groups = tuple(cfg["groups"])
        self.W = W

    def _support(self, i, y_hat, means, scales):
        if i == 0:
            return torch.cat([means, scales], dim=1)
        cc_in = y_hat[0] if i == 1 else torch.cat([y_hat[0], y_hat[-1]], dim=1)
        cc = R.conv_stack(self.W, f"cc_transforms_{i - 1}", cc_in)
        return torch.cat([cc, means, scales], dim=1)

    def _params(self, i, ctx, support):
        """Means and scales (in that order) of group i."""
        p = R.conv_stack(self.W, f"param_aggregation_{i}", torch.cat([ctx, support], dim=1))
        return p.chunk(2, dim=1)

    def _chain(self, z_sym, code):
        """The groups in coding order; ``code(k, means_packed)`` gives plane
        k's symbols (2 i: group i's anchors, 2 i + 1: its non-anchors)."""
        W = self.W
        med = R.eb_medians(W)[None, :, None, None]
        means, scales = R.h_s(W, C.nchw(z_sym).float() + med).chunk(2, dim=1)
        y_hat = []
        for i, g in enumerate(self.groups):
            sup = self._support(i, y_hat, means, scales)
            B, _, H, Wd = sup.shape
            ma, _ = self._params(i, sup.new_zeros((B, 2 * g, H, Wd)), sup)
            ma_p = R.pack(ma, C.ANCHOR)
            ya = R.unpack(code(2 * i, ma_p).float() + ma_p, C.ANCHOR)
            mn, _ = self._params(i, R.masked_conv(W, f"context_prediction_{i}", ya), sup)
            mn_p = R.pack(mn, C.NON_ANCHOR)
            y_hat.append(ya + R.unpack(code(2 * i + 1, mn_p).float() + mn_p, C.NON_ANCHOR))
        return y_hat

    def encode(self, x, jpeg=None):
        """NHWC [0, 1] -> {"symbols": [z, anchor 0, non-anchor 0, ...] int16,
        z NHWC, the y classes packed NHWC half planes}."""
        W = self.W
        y = R.g_a(W, C.nchw(C.pad_to(x, 64)))
        z = R.h_a(W, y)
        z_sym = C.nhwc(R.symbols(z, R.eb_medians(W)[None, :, None, None]))
        ys = torch.split(y, self.groups, dim=1)
        syms = []

        def code(k, means_p):
            s = R.symbols(R.pack(ys[k // 2], k % 2), means_p)
            syms.append(s)
            return s

        self._chain(z_sym, code)
        return {"symbols": [z_sym] + syms}

    def decode(self, syms, height: int, width: int, jpeg=None):
        y_hat = self._chain(syms[0], lambda k, _m: syms[k + 1])
        x = C.nhwc(R.g_s(self.W, torch.cat(y_hat, dim=1)))[:, :height, :width]
        return torch.clamp(x, 0.0, 1.0)
