"""Layer kit for HyRES in PyTorch (NCHW).

Counterparts of the layers of ``hyres_tpu/nn/layers.py`` that HyRES uses:
``Conv``/``Deconv``/``GDN`` (``:39-160``), ``ResidualBottleneckBlock``,
``_ResidualUnit``, ``AttentionBlock``, ``CheckboardMaskedConv``
(``:164-245``), the Cheng2020 blocks ``pixel_shuffle``,
``SubpelConv3x3``, ``ResidualBlock``, ``ResidualBlockWithStride`` and
``ResidualBlockUpsample`` (``:246-320``) and the refinement stack ``SEBlock``, ``SpatialAttention``,
``PReLU``, ``_DilatedBlock``, ``_resize_bilinear``, ``MultiScaleRefine``
(``:322-420``).

Each module with parameters has ``reset_parameters(generator=None)``
with the reference's initialisers, run by its constructor: flax's
``lecun_normal`` kernels (a truncated normal, fan-in ``k*k*cin`` of the
HWIO kernel, for transposed and masked convolutions too), zero biases,
GDN ``beta``/``gamma`` at their reparameterised 1 and ``0.1 I``, PReLU
0.25. ``init_parameters(model, generator)`` redraws a whole model from
one generator. Loading weights (``utils/convert.py``) overwrites them.

Submodules and parameters carry the reference's flax names (``Conv_0``,
``GDN_1``, ``_ResidualUnit_3``, ``kernel`` -> ``weight``), so a flax
parameter path maps to a state-dict key mechanically
(``utils/convert.py``). Precision policy, as in the reference: every
convolution and dense layer runs in its INPUT's dtype (float32 master
weights are cast at use); the GDN norm always runs in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy.bound import lower_bound

# flax's variance_scaling: the stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated to +-2 stddev by the inverse
    CDF of a uniform draw (as ``jax.random.truncated_normal``), scaled to
    variance 1/fan_in."""
    a, b = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(w.shape, generator=generator, device=w.device) * (b - a) + a
    t = torch.clamp(math.sqrt(2) * torch.erfinv(u), -2.0, 2.0)
    return w.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def init_parameters(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Redraw every parameter of ``model`` with the reference's
    initialisers, from ``generator``."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model


class _Conv2d(nn.Module):
    """Plain 2-D convolution whose weights are cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        cout, cin, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation)


class Conv(nn.Module):
    """k x k conv, stride s, padding k//2 (reference ``Conv``; the flax
    wrapper's inner ``nn.Conv`` is the child ``Conv_0``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 5, stride: int = 2):
        super().__init__()
        self.Conv_0 = _Conv2d(cin, cout, kernel, stride, kernel // 2)

    def forward(self, x):
        return self.Conv_0(x)


def conv1x1(cin: int, cout: int) -> Conv:
    return Conv(cin, cout, kernel=1, stride=1)


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv:
    return Conv(cin, cout, kernel=3, stride=stride)


class Deconv(nn.Module):
    """Transposed conv with ``ConvTranspose2d(k, s, padding=k//2,
    output_padding=s-1)`` geometry: output is exactly ``s * H``.

    The reference stores an HWIO kernel for an input-dilated correlation;
    ``utils/convert.py`` flips it spatially into this (I, O, k, k)
    ``conv_transpose2d`` weight (held by ``tests/test_torch_layers.py``).
    """

    def __init__(self, cin: int, cout: int, kernel: int = 5, stride: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.kernel, self.stride = kernel, stride
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        # fan-in of the reference's HWIO kernel, k*k*cin (torch's own fan
        # computation would take dim 1, cout, for this layout)
        cin, _, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
            self.kernel // 2, self.stride - 1)


_REPARAM_OFFSET = 2.0 ** -18


def _nonneg_init(value: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(value + _REPARAM_OFFSET ** 2, _REPARAM_OFFSET ** 2))


def _nonneg(stored: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    bound = (minimum + _REPARAM_OFFSET ** 2) ** 0.5
    return lower_bound(stored, bound) ** 2 - _REPARAM_OFFSET ** 2


class GDN(nn.Module):
    """Generalized divisive normalization ``x_i / sqrt(beta_i + sum_j
    gamma_ij x_j^2)``; ``inverse=True`` multiplies (IGDN). beta/gamma are
    stored reparameterized, as the reference stores them."""

    def __init__(self, channels: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(channels))
        self.gamma = nn.Parameter(torch.zeros(channels, channels))
        self.inverse, self.beta_min, self.gamma_init = inverse, beta_min, gamma_init
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        C = self.beta.shape[0]
        self.beta.copy_(_nonneg_init(torch.ones(C)))
        self.gamma.copy_(_nonneg_init(self.gamma_init * torch.eye(C)))

    def forward(self, x):
        beta = _nonneg(self.beta, self.beta_min)
        gamma = _nonneg(self.gamma)
        C = gamma.shape[0]
        xf = x.to(torch.float32)  # the norm always runs in float32
        norm = F.conv2d(xf * xf, gamma.reshape(C, C, 1, 1), beta)
        out = xf * torch.sqrt(norm) if self.inverse else xf * torch.rsqrt(norm)
        return out.to(x.dtype)


class ResidualBottleneckBlock(nn.Module):
    """1x1(C->C/2) -> ReLU -> 3x3 -> ReLU -> 1x1(C/2->C) + identity."""

    def __init__(self, C: int):
        super().__init__()
        self.Conv_0 = conv1x1(C, C // 2)
        self.Conv_1 = conv3x3(C // 2, C // 2)
        self.Conv_2 = conv1x1(C // 2, C)

    def forward(self, x):
        h = F.relu(self.Conv_0(x))
        h = F.relu(self.Conv_1(h))
        return x + self.Conv_2(h)


class _ResidualUnit(ResidualBottleneckBlock):
    """Inner unit of AttentionBlock: the bottleneck block, then ReLU."""

    def forward(self, x):
        return F.relu(super().forward(x))


class AttentionBlock(nn.Module):
    """Cheng2020 non-local attention: ``x + a * sigmoid(b)``. Units 0-2 are
    the trunk a, units 3-5 and ``Conv_0`` the gate b (flax call order)."""

    def __init__(self, C: int):
        super().__init__()
        for i in range(6):
            self.add_module(f"_ResidualUnit_{i}", _ResidualUnit(C))
        self.Conv_0 = conv1x1(C, C)

    def forward(self, x):
        return self.gate(x, x)

    def gate(self, x, g):
        """``x + a(x) * sigmoid(b(g))``: the trunk on ``x``, the gate on
        ``g`` (TCM's SWAtten gates on its Swin block's output)."""
        units = [getattr(self, f"_ResidualUnit_{i}") for i in range(6)]
        a = x
        for u in units[:3]:
            a = u(a)
        b = g
        for u in units[3:]:
            b = u(b)
        b = self.Conv_0(b)
        return x + a * torch.sigmoid(b)


class CheckboardMaskedConv(nn.Module):
    """5x5 conv whose kernel is zeroed where (i + j) is even: only
    anchor-parity neighbours feed the non-anchor context."""

    def __init__(self, cin: int, cout: int, kernel: int = 5):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        ii = torch.arange(kernel)[:, None]
        jj = torch.arange(kernel)[None, :]
        self.register_buffer("mask", ((ii + jj) % 2 == 1).to(torch.float32),
                             persistent=False)
        self.padding = kernel // 2
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        cout, cin, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        w = (self.weight * self.mask).to(x.dtype)
        return F.conv2d(x, w, self.bias.to(x.dtype), 1, self.padding)


# -- Cheng2020 building blocks (CompressAI's residual blocks) ---------------


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW depth-to-space in torch's channel order (input channel
    ``(c * r + dy) * r + dx``), the order of the reference's NHWC
    ``pixel_shuffle``."""
    return F.pixel_shuffle(x, r)


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)  # flax's slope


class SubpelConv3x3(nn.Module):
    """3x3 conv to ``cout * r^2`` channels, then pixel shuffle."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__()
        self.Conv_0 = conv3x3(cin, cout * r * r)
        self.r = r

    def forward(self, x):
        return pixel_shuffle(self.Conv_0(x), self.r)


class ResidualBlock(nn.Module):
    """conv3x3 -> LeakyReLU -> conv3x3 -> LeakyReLU, plus the input (through
    a 1x1 ``Conv_2`` when the widths differ)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = conv3x3(cin, cout)
        self.Conv_1 = conv3x3(cout, cout)
        if cin != cout:
            self.Conv_2 = conv1x1(cin, cout)

    def forward(self, x):
        h = _leaky_relu(self.Conv_1(_leaky_relu(self.Conv_0(x))))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class ResidualBlockWithStride(nn.Module):
    """conv3x3 (stride s) -> LeakyReLU -> conv3x3 -> GDN, plus a strided 1x1
    skip ``Conv_2``."""

    def __init__(self, cin: int, cout: int, stride: int = 2):
        super().__init__()
        self.Conv_0 = conv3x3(cin, cout, stride)
        self.Conv_1 = conv3x3(cout, cout)
        self.GDN_0 = GDN(cout)
        if stride != 1 or cin != cout:
            self.Conv_2 = Conv(cin, cout, kernel=1, stride=stride)

    def forward(self, x):
        h = self.GDN_0(self.Conv_1(_leaky_relu(self.Conv_0(x))))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class ResidualBlockUpsample(nn.Module):
    """Sub-pixel up -> LeakyReLU -> conv3x3 -> IGDN, plus a sub-pixel skip
    (``SubpelConv3x3_1``)."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__()
        self.SubpelConv3x3_0 = SubpelConv3x3(cin, cout, r)
        self.Conv_0 = conv3x3(cout, cout)
        self.GDN_0 = GDN(cout, inverse=True)
        self.SubpelConv3x3_1 = SubpelConv3x3(cin, cout, r)

    def forward(self, x):
        h = self.GDN_0(self.Conv_0(_leaky_relu(self.SubpelConv3x3_0(x))))
        return self.SubpelConv3x3_1(x) + h


class Dense(nn.Module):
    """Bias-free linear layer in the input's dtype (flax ``nn.Dense``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, C: int, reduction: int = 16):
        super().__init__()
        self.Dense_0 = Dense(C, C // reduction)
        self.Dense_1 = Dense(C // reduction, C)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial attention: 7x7 conv over [avg, max] channel pools."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.Conv_0 = _Conv2d(2, 1, kernel, padding=(kernel - 1) // 2, bias=False)

    def forward(self, x):
        a = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.Conv_0(a))


class PReLU(nn.Module):
    """Single-parameter PReLU."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = init
        self.alpha = nn.Parameter(torch.tensor(init))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.alpha.fill_(self.init)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _DilatedBlock(nn.Module):
    """conv3x3(d=1) -> PReLU -> conv3x3(d=2) -> PReLU."""

    def __init__(self, C: int):
        super().__init__()
        self.Conv_0 = _Conv2d(C, C, 3, padding=1)
        self.PReLU_0 = PReLU()
        self.Conv_1 = _Conv2d(C, C, 3, padding=2, dilation=2)
        self.PReLU_1 = PReLU()

    def forward(self, x):
        return self.PReLU_1(self.Conv_1(self.PReLU_0(self.Conv_0(x))))


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres and no antialiasing (the
    reference's ``jax.image.resize(..., antialias=False)``)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


class MultiScaleRefine(nn.Module):
    """Post-processing artifact remover: SE-gated features, dilated-conv
    branches at 1/1, 1/2 and 1/4 scale, spatial attention, 1x1 + 3x3
    fusion to an RGB residual."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 out_channels: int = 3):
        super().__init__()
        C = mid_channels
        self.Conv_0 = _Conv2d(in_channels, C, 3, padding=1)
        self.PReLU_0 = PReLU()
        self.SEBlock_0 = SEBlock(C, reduction=16)
        for i in range(3):
            self.add_module(f"_DilatedBlock_{i}", _DilatedBlock(C))
        self.SpatialAttention_0 = SpatialAttention()
        self.Conv_1 = _Conv2d(3 * C, C, 1)
        self.PReLU_1 = PReLU()
        self.Conv_2 = _Conv2d(C, out_channels, 3, padding=1)

    def forward(self, x):
        feat = self.SEBlock_0(self.PReLU_0(self.Conv_0(x)))
        H, W = feat.shape[2], feat.shape[3]
        f1 = self._DilatedBlock_0(feat)
        f2 = self._DilatedBlock_1(_resize_bilinear(feat, H // 2, W // 2))
        f2 = _resize_bilinear(f2, H, W)
        f3 = self._DilatedBlock_2(_resize_bilinear(feat, H // 4, W // 4))
        f3 = _resize_bilinear(f3, H, W)
        multi = torch.cat([f1, f2, f3], dim=1)
        multi = multi * self.SpatialAttention_0(multi)
        return self.Conv_2(self.PReLU_1(self.Conv_1(multi)))
