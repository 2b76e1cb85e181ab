"""The transformer layers of TCM (Liu, Sun and Katto, CVPR 2023,
arXiv:2303.14978), after LIC_TCM's ``models/tcm.py`` and the SCUNet window
attention it reuses.

* ``WindowAttention``: W or SW multi-head self-attention over p x p
  windows with a learned (heads, 2p - 1, 2p - 1) relative-position table;
  its core is kernel K7 (``kernels/window_attn.py``), between the one
  ``Linear(C -> 3C)`` and the output ``Linear(C -> C)``, which act token by
  token and so commute with the roll and the partition;
* ``Block``: ``x + WMSA(LN(x))``, then ``x + MLP(LN(x))`` (MLP C -> 4C ->
  C with the exact GELU), on NHWC tensors;
* ``ConvTransBlock``: a 1x1 convolution splits 2N channels into a
  residual-block branch and a transformer branch, a 1x1 convolution joins
  them, plus the input (NCHW);
* ``SwinBlock``: a W block, then an SW block (NCHW outward);
* ``SWAtten``: the slice transforms' attention: a 1x1 convolution to the
  inner width, a Swin block, CompressAI's attention gate (trunk on the
  input, gate on the Swin block's output), a 1x1 convolution back.

Names: ``LayerNorm`` holds flax's ``scale`` and ``bias`` and ``Linear`` a
``weight`` (out, in) and a ``bias``, so ``utils/convert.py`` maps the
layers to flax trees as it maps the others. Every layer runs float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import window_attn as k7
from ..utils.trace import span
from .layers import AttentionBlock, ResidualBlock, conv1x1, lecun_normal_

LN_EPS = 1e-5
REL_STD = 0.02  # the relative-position table's initial stddev


class Linear(nn.Module):
    """Dense layer with a bias, in the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last dimension, eps 1e-5, with flax's names."""

    def __init__(self, C: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LN_EPS)


class WindowAttention(nn.Module):
    """W (``shifted=False``) or SW multi-head self-attention of C channels in
    heads of ``head_dim`` over ``window`` x ``window`` windows, NHWC."""

    def __init__(self, C: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        if C % head_dim:
            raise ValueError(f"{C} channels do not split into heads of {head_dim}")
        self.heads, self.window, self.shifted = C // head_dim, window, shifted
        self.Dense_0 = Linear(C, 3 * C)
        self.Dense_1 = Linear(C, C)
        self.relative_position_params = nn.Parameter(
            torch.zeros(self.heads, 2 * window - 1, 2 * window - 1))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        p = self.relative_position_params
        lecun_normal_(p, 1, generator).mul_(REL_STD)  # a +-2 sigma truncated normal

    def bias_table(self) -> torch.Tensor:
        """The (heads, p^2, p^2) gathered table; outside autograd, gathered
        once and kept until the parameters change."""
        p = self.relative_position_params
        if p.requires_grad and torch.is_grad_enabled():
            return k7.relative_bias(p, self.window)
        key = (p.data_ptr(), p._version)
        if getattr(self, "_table_key", None) != key:
            self._table = k7.relative_bias(p.detach(), self.window)
            self._table_key = key
        return self._table

    def forward(self, x):
        qkv = self.Dense_0(x).contiguous()
        with span("model.window_attn"):
            o = k7.window_attention(qkv, self.bias_table(), self.heads, self.window,
                                    self.shifted)
        return self.Dense_1(o)


class Block(nn.Module):
    """``x + WMSA(LN(x))``, then ``x + MLP(LN(x))``; NHWC."""

    def __init__(self, C: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(C)
        self.WindowAttention_0 = WindowAttention(C, head_dim, window, shifted)
        self.LayerNorm_1 = LayerNorm(C)
        self.Dense_0 = Linear(C, 4 * C)
        self.Dense_1 = Linear(4 * C, C)

    def forward(self, x):
        x = x + self.WindowAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))


class ConvTransBlock(nn.Module):
    """TCM's mixed block on 2N channels (NCHW): ``(a, b) = split(1x1(x))``,
    ``a <- RB(a) + a``, ``b <- Block(b)``, then ``x + 1x1(cat(a, b))``."""

    def __init__(self, N: int, head_dim: int, window: int, shifted: bool):
        super().__init__()
        self.N = N
        self.Conv_0 = conv1x1(2 * N, 2 * N)
        self.ResidualBlock_0 = ResidualBlock(N, N)
        self.Block_0 = Block(N, head_dim, window, shifted)
        self.Conv_1 = conv1x1(2 * N, 2 * N)

    def forward(self, x):
        a, b = torch.split(self.Conv_0(x), (self.N, self.N), dim=1)
        a = self.ResidualBlock_0(a) + a
        b = self.Block_0(b.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.Conv_1(torch.cat([a, b], dim=1))


class SwinBlock(nn.Module):
    """A W block, then an SW block, on NCHW tensors."""

    def __init__(self, C: int, head_dim: int, window: int):
        super().__init__()
        self.Block_0 = Block(C, head_dim, window, False)
        self.Block_1 = Block(C, head_dim, window, True)

    def forward(self, x):
        return self.Block_1(self.Block_0(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)


class SWAtten(nn.Module):
    """``out(t + a(t) * sigmoid(b(Swin(t))))``, ``t = in(x)``: CompressAI's
    attention gate around a Swin block at the inner width (NCHW)."""

    def __init__(self, C: int, head_dim: int = 16, window: int = 8, inter: int = 128):
        super().__init__()
        self.Conv_0 = conv1x1(C, inter)
        self.SwinBlock_0 = SwinBlock(inter, head_dim, window)
        self.AttentionBlock_0 = AttentionBlock(inter)
        self.Conv_1 = conv1x1(inter, C)

    def forward(self, x):
        t = self.Conv_0(x)
        return self.Conv_1(self.AttentionBlock_0.gate(t, self.SwinBlock_0(t)))
