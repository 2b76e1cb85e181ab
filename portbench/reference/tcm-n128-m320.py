"""Plain reference of TCM, "Learned Image Compression with Mixed
Transformer-CNN Architectures" (Liu, Sun and Katto, CVPR 2023,
arXiv:2303.14978), at N = 128, M = 320, in float32 PyTorch.

Written from the paper and its published code (LIC_TCM ``models/tcm.py``
and the SCUNet window attention it reuses), not from the program: no
module of the program is imported. Tensors are NCHW between layers and
NHWC inside the transformer blocks; ``W`` maps the program's parameter
names to tensors (convolutions OIHW, dense layers (out, in)).

The attention (``wmsa``) is SCUNet's, done literally: roll the image by
(-p/2, -p/2) for SW, cut it into p x p windows, take q, k and v from the
(threeh c) channel layout of one Linear, scores ``q k^T / sqrt(d)`` plus
the relative-position bias, SCUNet's ``generate_mask`` for SW, softmax,
the product with v, the windows put back and the roll undone. It runs a
block of windows at a time (``WINDOW_BLOCK``) so that a 768x512 image's
first stage does not hold its whole score tensor at once.

Departures from LIC_TCM, each forced by the setting:

* the weights are the benchmark's seeded ones, not a trained checkpoint
  (none is in the repository);
* the input pads to a multiple of 128 by repeating its edge (LIC_TCM's
  ``eval.py`` pads with zeros): the padding serves only to keep every
  window whole, and the repository's codecs pad by their edge;
* z's symbols are round(z - medians) of the factorized prior, and its
  decode adds the medians back (CompressAI's ``EntropyBottleneck``);
* ``SwinBlock``'s padding of inputs no larger than a window (which
  LIC_TCM never undoes) is left out: at the cell's sizes no stage is that
  small.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.reference import nets as R

WINDOW_BLOCK = 256  # windows a score tensor holds at most
LN_EPS = 1e-5


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


def _conv(W, name, x, stride=1):
    return R.conv_s(W, name, x, stride)


def _subpel(W, name, x):
    return F.pixel_shuffle(_conv(W, name + ".Conv_0", x), 2)


def res_block(W, name, x):
    """CompressAI's ResidualBlock: conv3x3, LeakyReLU, conv3x3, LeakyReLU,
    plus the input."""
    return x + _lrelu(_conv(W, name + ".Conv_1", _lrelu(_conv(W, name + ".Conv_0", x))))


def res_block_stride(W, name, x):
    h = _conv(W, name + ".Conv_1", _lrelu(_conv(W, name + ".Conv_0", x, 2)))
    h = R.gdn(W, name + ".GDN_0", h)
    return _conv(W, name + ".Conv_2", x, 2) + h


def res_block_up(W, name, x):
    h = _conv(W, name + ".Conv_0", _lrelu(_subpel(W, name + ".SubpelConv3x3_0", x)))
    return _subpel(W, name + ".SubpelConv3x3_1", x) + R.gdn(W, name + ".GDN_0", h, inverse=True)


def linear(W, name, x):
    return F.linear(x, W[name + ".weight"], W[name + ".bias"])


def layer_norm(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".scale"], W[name + ".bias"], LN_EPS)


def relative_embedding(params, p):
    """(h, 2p-1, 2p-1) -> (h, p^2, p^2), SCUNet's ``relative_embedding``."""
    cord = torch.tensor([[i, j] for i in range(p) for j in range(p)], device=params.device)
    rel = cord[:, None, :] - cord[None, :, :] + p - 1
    return params[:, rel[:, :, 0], rel[:, :, 1]]


def generate_mask(hw, ww, p, shift, device):
    """SCUNet's ``generate_mask``: (hw ww, p^2, p^2), True where masked."""
    m = torch.zeros(hw, ww, p, p, p, p, dtype=torch.bool, device=device)
    s = p - shift
    m[-1, :, :s, :, s:, :] = True
    m[-1, :, s:, :, :s, :] = True
    m[:, -1, :, :s, :, s:] = True
    m[:, -1, :, s:, :, :s] = True
    return m.reshape(hw, ww, p * p, p * p).reshape(hw * ww, p * p, p * p)


def wmsa(W, name, x, d, p, shifted):
    """SCUNet's WMSA on NHWC x: W or SW window attention, heads of width d."""
    B, H, Wd, Cc = x.shape
    h = Cc // d
    if shifted:
        x = torch.roll(x, shifts=(-(p // 2), -(p // 2)), dims=(1, 2))
    hw, ww = H // p, Wd // p
    x = x.reshape(B, hw, p, ww, p, Cc).permute(0, 1, 3, 2, 4, 5).reshape(B, hw * ww, p * p, Cc)
    qkv = linear(W, name + ".Dense_0", x)  # (B, nw, np, 3C): (threeh c)
    qkv = qkv.reshape(B, hw * ww, p * p, 3 * h, d).permute(3, 0, 1, 2, 4)
    q, k, v = qkv[:h], qkv[h:2 * h], qkv[2 * h:]
    bias = relative_embedding(W[name + ".relative_position_params"], p)[:, None, None]
    mask = generate_mask(hw, ww, p, p // 2, x.device) if shifted else None
    outs = []
    for w0 in range(0, hw * ww, WINDOW_BLOCK):
        w1 = min(w0 + WINDOW_BLOCK, hw * ww)
        sim = torch.einsum("hbwpc,hbwqc->hbwpq", q[:, :, w0:w1], k[:, :, w0:w1]) * (d ** -0.5)
        sim = sim + bias
        if mask is not None:
            sim = sim.masked_fill(mask[w0:w1], float("-inf"))
        outs.append(torch.einsum("hbwij,hbwjc->hbwic", torch.softmax(sim, dim=-1),
                                 v[:, :, w0:w1]))
    o = torch.cat(outs, dim=2).permute(1, 2, 3, 0, 4).reshape(B, hw * ww, p * p, Cc)
    o = linear(W, name + ".Dense_1", o)
    o = o.reshape(B, hw, ww, p, p, Cc).permute(0, 1, 3, 2, 4, 5).reshape(B, H, Wd, Cc)
    if shifted:
        o = torch.roll(o, shifts=(p // 2, p // 2), dims=(1, 2))
    return o


def block(W, name, x, d, p, shifted):
    """The transformer block on NHWC x."""
    x = x + wmsa(W, name + ".WindowAttention_0", layer_norm(W, name + ".LayerNorm_0", x),
                 d, p, shifted)
    mlp = linear(W, name + ".Dense_1", F.gelu(linear(W, name + ".Dense_0",
                                                    layer_norm(W, name + ".LayerNorm_1", x))))
    return x + mlp


def conv_trans_block(W, name, x, d, p, shifted):
    """TCM's ConvTransBlock on NCHW x of 2N channels."""
    n = x.shape[1] // 2
    a, b = torch.split(_conv(W, name + ".Conv_0", x), (n, n), dim=1)
    a = res_block(W, name + ".ResidualBlock_0", a) + a
    b = block(W, name + ".Block_0", b.permute(0, 2, 3, 1), d, p, shifted).permute(0, 3, 1, 2)
    return x + _conv(W, name + ".Conv_1", torch.cat([a, b], dim=1))


def stage(W, name, x, first, d, p):
    """Two ConvTransBlocks, W then SW."""
    for k in range(2):
        x = conv_trans_block(W, f"{name}.ConvTransBlock_{first + k}", x, d, p, bool(k))
    return x


def swatten(W, name, x, d, p):
    """SWAtten: in 1x1, a Swin block (W, SW), CompressAI's attention gate
    with its trunk on t and its gate on the Swin block's output, out 1x1."""
    t = _conv(W, name + ".Conv_0", x)
    z = t.permute(0, 2, 3, 1)
    z = block(W, name + ".SwinBlock_0.Block_0", z, d, p, False)
    z = block(W, name + ".SwinBlock_0.Block_1", z, d, p, True).permute(0, 3, 1, 2)
    a = t
    for i in range(3):
        a = F.relu(R.bottleneck_block(W, f"{name}.AttentionBlock_0._ResidualUnit_{i}", a))
    b = z
    for i in range(3, 6):
        b = F.relu(R.bottleneck_block(W, f"{name}.AttentionBlock_0._ResidualUnit_{i}", b))
    u = t + a * torch.sigmoid(_conv(W, name + ".AttentionBlock_0.Conv_0", b))
    return _conv(W, name + ".Conv_1", u)


def cc_stack(W, name, x):
    x = F.gelu(_conv(W, name + ".Conv_0", x))
    x = F.gelu(_conv(W, name + ".Conv_1", x))
    return _conv(W, name + ".Conv_2", x)


class Reference:
    def __init__(self, cfg: dict, W: dict):
        self.cfg, self.W = cfg, W
        self.hd = [int(d) for d in cfg["head_dims"]]
        self.p, self.hp = int(cfg["window"]), int(cfg["hyper_window"])
        self.hyper_d = int(cfg["hyper_head_dim"])
        self.slices = int(cfg["slices"])
        self.sc = int(cfg["M"]) // self.slices

    def g_a(self, x):
        W = self.W
        x = res_block_stride(W, "g_a.ResidualBlockWithStride_0", x)
        for s in range(3):
            x = stage(W, "g_a", x, 2 * s, self.hd[s], self.p)
            if s < 2:
                x = res_block_stride(W, f"g_a.ResidualBlockWithStride_{s + 1}", x)
        return _conv(W, "g_a.Conv_0", x, 2)

    def g_s(self, y):
        W = self.W
        x = res_block_up(W, "g_s.ResidualBlockUpsample_0", y)
        for s in range(3):
            x = stage(W, "g_s", x, 2 * s, self.hd[3 + s], self.p)
            if s < 2:
                x = res_block_up(W, f"g_s.ResidualBlockUpsample_{s + 1}", x)
        return _subpel(W, "g_s.SubpelConv3x3_0", x)

    def h_a(self, y):
        x = res_block_stride(self.W, "h_a.ResidualBlockWithStride_0", y)
        x = stage(self.W, "h_a", x, 0, self.hyper_d, self.hp)
        return _conv(self.W, "h_a.Conv_0", x, 2)

    def h_s(self, name, z):
        x = res_block_up(self.W, name + ".ResidualBlockUpsample_0", z)
        x = stage(self.W, name, x, 0, self.hyper_d, self.hp)
        return _subpel(self.W, name + ".SubpelConv3x3_0", x)

    def _med(self):
        return R.eb_medians(self.W)[None, :, None, None]

    def chain(self, z_sym, code):
        """The slices in order; ``code(i, means)`` gives slice i's symbols
        (NHWC int16). -> (y_hat slices NCHW, [(means, scales)] NCHW)."""
        W, cfg = self.W, self.cfg
        z_hat = C.nchw(z_sym).float() + self._med()
        means, scales = self.h_s("h_mean_s", z_hat), self.h_s("h_scale_s", z_hat)
        d, p = int(cfg["swatten_head_dim"]), self.p
        y_hat, params = [], []
        for i in range(self.slices):
            support = y_hat[:int(cfg["max_support"])]
            ms = swatten(W, f"atten_mean_{i}", torch.cat([means, *support], dim=1), d, p)
            ss = swatten(W, f"atten_scale_{i}", torch.cat([scales, *support], dim=1), d, p)
            mu = cc_stack(W, f"cc_mean_{i}", ms)
            sigma = cc_stack(W, f"cc_scale_{i}", ss)
            params.append((mu, sigma))
            yh = C.nchw(code(i, mu)).float() + mu
            lrp = cc_stack(W, f"lrp_{i}", torch.cat([ms, yh], dim=1))
            y_hat.append(yh + 0.5 * torch.tanh(lrp))
        return y_hat, params

    def encode(self, x, jpeg=None):
        """NHWC [0, 1] -> {"symbols": [z, slice 0, ..., slice 4]} int16 NHWC."""
        y = self.g_a(C.nchw(C.pad_to(x, int(self.cfg["pad"]))))
        z_sym = C.nhwc(R.symbols(self.h_a(y), self._med()))
        ys = torch.split(y, self.sc, dim=1)
        syms = []

        def code(i, mu):
            syms.append(C.nhwc(R.symbols(ys[i], mu)))
            return syms[-1]

        self.chain(z_sym, code)
        return {"symbols": [z_sym] + syms}

    def decode(self, syms, height: int, width: int, jpeg=None):
        y_hat, _ = self.chain(syms[0], lambda i, _m: syms[i + 1])
        x = C.nhwc(self.g_s(torch.cat(y_hat, dim=1)))[:, :height, :width]
        return torch.clamp(x, 0.0, 1.0)
