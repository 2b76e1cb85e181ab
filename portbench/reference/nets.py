"""Plain PyTorch layers of the checkerboard codecs, as functions of a flat
weight dict.

Written from the published descriptions (Minnen et al. 2018's hyperprior,
He et al. 2021's checkerboard context, Cheng et al. 2020's attention
block, CompressAI's GDN and residual blocks, the HyRES refinement CNN),
not from the program: no module of the program is imported. ``W`` maps
dotted names (``g_a.Conv_0.Conv_0.weight``) to tensors in PyTorch
layouts: convolutions OIHW, transposed convolutions (I, O, kH, kW) for
``conv_transpose2d``, dense layers (out, in). Tensors are NCHW, float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

REPARAM_OFFSET = 2.0 ** -18
LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11
SYMBOL_BOUND = 32000


class _LowerBound(torch.autograd.Function):
    """max(x, b); the gradient passes where x >= b or where it would raise
    x (CompressAI's ``LowerBound``)."""

    @staticmethod
    def forward(ctx, x, b: float):
        ctx.save_for_backward(x)
        ctx.b = b
        return torch.clamp_min(x, b)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.b) | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x, b: float):
    return _LowerBound.apply(x, b)


def conv(W, name, x, stride=1, padding=None, dilation=1):
    w = W[name + ".weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(x, w, W.get(name + ".bias"), stride, pad, dilation)


def conv_s(W, name, x, stride=2):
    """A ``Conv`` wrapper (k x k, padding k // 2) around its inner conv."""
    return conv(W, name + ".Conv_0", x, stride)


def deconv(W, name, x, stride=2):
    """Transposed conv to exactly ``stride`` times the size."""
    w = W[name + ".weight"]
    return F.conv_transpose2d(x, w, W[name + ".bias"], stride, w.shape[-1] // 2, stride - 1)


def gdn(W, name, x, inverse=False, beta_min=1e-6):
    """x / sqrt(beta + gamma x^2) (or times it, inverse), beta and gamma
    stored reparameterised: value = max(stored, bound)^2 - offset^2."""
    off2 = REPARAM_OFFSET ** 2
    beta = lower_bound(W[name + ".beta"], (beta_min + off2) ** 0.5) ** 2 - off2
    gamma = lower_bound(W[name + ".gamma"], off2 ** 0.5) ** 2 - off2
    C = beta.shape[0]
    norm = F.conv2d(x * x, gamma.reshape(C, C, 1, 1), beta)
    return x * torch.sqrt(norm) if inverse else x * torch.rsqrt(norm)


def bottleneck_block(W, name, x):
    h = F.relu(conv_s(W, name + ".Conv_0", x, 1))
    h = F.relu(conv_s(W, name + ".Conv_1", h, 1))
    return x + conv_s(W, name + ".Conv_2", h, 1)


def attention_block(W, name, x):
    """Cheng 2020's simplified attention: x + a(x) * sigmoid(b(x))."""
    a = x
    for i in range(3):
        a = F.relu(bottleneck_block(W, f"{name}._ResidualUnit_{i}", a))
    b = x
    for i in range(3, 6):
        b = F.relu(bottleneck_block(W, f"{name}._ResidualUnit_{i}", b))
    return x + a * torch.sigmoid(conv_s(W, name + ".Conv_0", b, 1))


def g_a(W, x):
    x = gdn(W, "g_a.GDN_0", conv_s(W, "g_a.Conv_0", x))
    x = attention_block(W, "g_a.AttentionBlock_0", bottleneck_block(W, "g_a.ResidualBottleneckBlock_0", x))
    x = gdn(W, "g_a.GDN_1", conv_s(W, "g_a.Conv_1", x))
    x = bottleneck_block(W, "g_a.ResidualBottleneckBlock_1", x)
    return attention_block(W, "g_a.AttentionBlock_1", conv_s(W, "g_a.Conv_2", x))


def g_s(W, y):
    x = deconv(W, "g_s.Deconv_0", attention_block(W, "g_s.AttentionBlock_0", y))
    x = gdn(W, "g_s.GDN_0", bottleneck_block(W, "g_s.ResidualBottleneckBlock_0", x), inverse=True)
    x = attention_block(W, "g_s.AttentionBlock_1", deconv(W, "g_s.Deconv_1", x))
    x = gdn(W, "g_s.GDN_1", bottleneck_block(W, "g_s.ResidualBottleneckBlock_1", x), inverse=True)
    return deconv(W, "g_s.Deconv_2", x)


def h_a(W, y):
    y = F.relu(conv_s(W, "h_a.Conv_0", y, 1))
    y = F.relu(conv_s(W, "h_a.Conv_1", y))
    return conv_s(W, "h_a.Conv_2", y)


def h_s(W, z):
    z = F.relu(deconv(W, "h_s.Deconv_0", z))
    z = F.relu(deconv(W, "h_s.Deconv_1", z))
    return conv_s(W, "h_s.Conv_0", z, 1)


def conv_stack(W, name, x, stride=1):
    """Three convolutions with ReLUs between (parameter aggregation and
    channel-context stacks)."""
    x = F.relu(conv_s(W, name + ".Conv_0", x, stride))
    x = F.relu(conv_s(W, name + ".Conv_1", x, stride))
    return conv_s(W, name + ".Conv_2", x, stride)


def masked_conv(W, name, x):
    """5x5 context convolution that sees only the anchor neighbours: the
    kernel is zero where (i + j) is even."""
    w = W[name + ".weight"]
    k = w.shape[-1]
    ii = torch.arange(k, device=w.device)[:, None]
    jj = torch.arange(k, device=w.device)[None, :]
    mask = ((ii + jj) % 2 == 1).to(w.dtype)
    return F.conv2d(x, w * mask, W[name + ".bias"], 1, k // 2)


def parity(h, w, p, device, dtype=torch.float32):
    """(1, 1, H, W) mask, 1 where (i + j) % 2 == p (0: anchor)."""
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    return (((ii + jj) % 2) == p).to(dtype)[None, None]


def pack(x, p):
    """NCHW -> NHWC (B, H, W/2, C): the elements of parity class ``p``
    of each row, in column order."""
    B, C, H, W = x.shape
    cols = (torch.arange(W // 2, device=x.device)[None, :] * 2
            + ((torch.arange(H, device=x.device)[:, None] + p) % 2))
    return torch.gather(x, 3, cols.expand(B, C, H, W // 2)).permute(0, 2, 3, 1)


def unpack(v, p):
    """Inverse of ``pack``: NHWC half plane -> NCHW, zeros elsewhere."""
    B, H, Wh, C = v.shape
    out = torch.zeros((B, C, H, 2 * Wh), dtype=v.dtype, device=v.device)
    cols = (torch.arange(Wh, device=v.device)[None, :] * 2
            + ((torch.arange(H, device=v.device)[:, None] + p) % 2))
    return out.scatter(3, cols.expand(B, C, H, Wh), v.permute(0, 3, 1, 2))


def symbols(y, means):
    """Clipped int16 coder symbols round(y - means)."""
    return torch.clamp(torch.round(y - means), -SYMBOL_BOUND, SYMBOL_BOUND).to(torch.int16)


# -- entropy models (training likelihoods) -------------------------------------

def eb_logits(W, v, detach=False):
    """Logit of the factorized prior's CDF at v (C, 1, N) (Balle et al. 2018,
    appendix 6.1): per channel, softplus matrices, biases and tanh gates."""
    k = 0
    while f"entropy_bottleneck.matrix_{k}" in W:
        m, b = W[f"entropy_bottleneck.matrix_{k}"], W[f"entropy_bottleneck.bias_{k}"]
        f = W.get(f"entropy_bottleneck.factor_{k}")
        if detach:
            m, b = m.detach(), b.detach()
            f = None if f is None else f.detach()
        v = torch.matmul(F.softplus(m), v) + b
        if f is not None:
            v = v + torch.tanh(f) * torch.tanh(v)
        k += 1
    return v


def eb_medians(W):
    return W["entropy_bottleneck.quantiles"][:, 0, 1].detach()


def eb_likelihood(W, v):
    lower = eb_logits(W, v - 0.5)
    upper = eb_logits(W, v + 0.5)
    s = -torch.sign(lower + upper).detach()
    return lower_bound(torch.abs(torch.sigmoid(s * upper) - torch.sigmoid(s * lower)),
                       LIKELIHOOD_BOUND)


def eb_aux_loss(W, tail_mass=1e-9):
    """Sum |logit(quantiles) - [-t, 0, t]|, the density parameters detached."""
    q = W["entropy_bottleneck.quantiles"]
    t = torch.log(torch.tensor(2.0 / tail_mass - 1.0, dtype=torch.float64)).item()
    target = torch.tensor([-t, 0.0, t], dtype=q.dtype, device=q.device).reshape(1, 1, 3)
    return torch.sum(torch.abs(eb_logits(W, q, detach=True) - target))


def gaussian_likelihood(y, scales, means):
    """P(round(y) | N(means, scales)) as the box integral of the density."""
    s = lower_bound(scales, SCALE_BOUND)
    v = torch.abs(y - means)
    cdf = lambda t: 0.5 * torch.special.erfc(-t * 2 ** -0.5)  # noqa: E731
    return lower_bound(cdf((0.5 - v) / s) - cdf((-0.5 - v) / s), LIKELIHOOD_BOUND)


def to_eb(z):
    """NCHW z -> (C, 1, B*H*W), image-major: the prior's layout."""
    B, C, H, W = z.shape
    return z.permute(1, 0, 2, 3).reshape(C, 1, B * H * W)


def from_eb(v, shape):
    B, C, H, W = shape
    return v.reshape(C, B, H, W).permute(1, 0, 2, 3)


# -- HyRES refinement CNN ---------------------------------------------------------

def prelu(W, name, x):
    a = W[name + ".alpha"]
    return torch.where(x >= 0, x, a * x)


def _dilated(W, name, x):
    x = prelu(W, name + ".PReLU_0", conv(W, name + ".Conv_0", x, padding=1))
    return prelu(W, name + ".PReLU_1", conv(W, name + ".Conv_1", x, padding=2, dilation=2))


def _resize(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)


def refine(W, x, p="refine"):
    """Multi-scale refinement: SE-gated features, dilated branches at 1, 1/2
    and 1/4 scale, CBAM spatial attention, 1x1 + 3x3 fusion to RGB."""
    f = prelu(W, p + ".PReLU_0", conv(W, p + ".Conv_0", x, padding=1))
    g = f.mean(dim=(2, 3))
    g = torch.sigmoid(F.linear(F.relu(F.linear(g, W[p + ".SEBlock_0.Dense_0.weight"])),
                               W[p + ".SEBlock_0.Dense_1.weight"]))
    f = f * g[:, :, None, None]
    H, Wd = f.shape[2], f.shape[3]
    f1 = _dilated(W, p + "._DilatedBlock_0", f)
    f2 = _resize(_dilated(W, p + "._DilatedBlock_1", _resize(f, H // 2, Wd // 2)), H, Wd)
    f3 = _resize(_dilated(W, p + "._DilatedBlock_2", _resize(f, H // 4, Wd // 4)), H, Wd)
    m = torch.cat([f1, f2, f3], dim=1)
    att = torch.cat([m.mean(dim=1, keepdim=True), m.amax(dim=1, keepdim=True)], dim=1)
    m = m * torch.sigmoid(conv(W, p + ".SpatialAttention_0.Conv_0", att, padding=3))
    return conv(W, p + ".Conv_2", prelu(W, p + ".PReLU_1", conv(W, p + ".Conv_1", m)), padding=1)
