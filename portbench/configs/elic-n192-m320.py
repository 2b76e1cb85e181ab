"""ELIC at N=192, M=320, groups (16, 16, 32, 64, 192), on weights that the
benchmark makes on the device from the configuration's fixed seed.

No trained ELIC checkpoint exists here, so the weights follow the recipe
that makes a random ELIC codable (listed under ``assumed``): flax's
initialisers (a normal truncated to +-2 sigma with variance 1/fan-in for
every kernel, zero biases, GDN at beta 1 and gamma 0.1 I, the factorized
prior's own initialisation), each group's scale output bias at
``scale_bias``, and the factorized prior fitted to the z of a crop of the
photo (``prior_fit_*``), its quantiles then solved in closed form. The
same weights go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.lib.png import load_photo
from portbench.reference import common as C
from portbench.reference import nets as R

_TRUNC_STD = 0.87962566103423978  # stddev of a unit normal truncated to [-2, 2]
_EB_FILTERS = (3, 3, 3, 3)


def _shapes(cfg: dict) -> dict:
    """Parameter names and shapes: the program's layout of LightWeightELIC."""
    from hyres_tpu_torch.models.elic import LightWeightELIC

    m = LightWeightELIC(cfg["N"], cfg["M"], tuple(cfg["groups"]))
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def _init(shapes: dict, gen: torch.Generator, device) -> dict:
    """Initial weights, every truncated normal from one uniform draw."""
    W = {}
    kernels = [k for k, s in shapes.items() if k.endswith(".weight") and len(s) == 4]
    u = torch.rand(sum(math.prod(shapes[k]) for k in kernels), generator=gen, device=device)
    a, b = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    t = torch.clamp(math.sqrt(2) * torch.erfinv(u * (b - a) + a), -2.0, 2.0)
    o = 0
    for k in kernels:
        s = shapes[k]
        n = math.prod(s)
        deconv = k.split(".")[-2].startswith("Deconv_")
        fan_in = (s[0] if deconv else s[1]) * s[2] * s[3]
        W[k] = (t[o:o + n] * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).reshape(s)
        o += n
    off2 = R.REPARAM_OFFSET ** 2
    scale = 10.0 ** (1.0 / (len(_EB_FILTERS) + 1))
    dims = (1,) + _EB_FILTERS + (1,)
    for k, s in shapes.items():
        if k in W:
            continue
        leaf = k.split(".")[-1]
        if leaf == "bias":
            W[k] = torch.zeros(s, device=device)
        elif leaf == "beta":
            W[k] = torch.full(s, math.sqrt(1.0 + off2), device=device)
        elif leaf == "gamma":
            W[k] = torch.sqrt(0.1 * torch.eye(s[0], device=device) + off2)
        elif leaf.startswith("matrix_"):
            W[k] = torch.full(s, math.log(math.expm1(1.0 / scale / dims[int(leaf[7:]) + 1])),
                              device=device)
        elif leaf.startswith("bias_"):
            W[k] = torch.rand(s, generator=gen, device=device) - 0.5
        elif leaf.startswith("factor_"):
            W[k] = torch.zeros(s, device=device)
        elif leaf == "quantiles":
            W[k] = torch.tensor([-10.0, 0.0, 10.0], device=device).expand(s).contiguous()
        else:
            raise KeyError(f"no initialiser for {k}")
    return W


def _refit_quantiles(W: dict, tail_mass: float = 1e-9, iters: int = 80):
    """The x where the prior's CDF logit reaches [-t, 0, t], t = log(2 /
    tail_mass - 1), by bracket doubling and bisection (the logit is
    monotone in x)."""
    t = math.log(2.0 / tail_mass - 1.0)
    q = W["entropy_bottleneck.quantiles"]
    target = torch.tensor([-t, 0.0, t], device=q.device).reshape(1, 1, 3)
    lo, hi = torch.full_like(q, -1.0), torch.full_like(q, 1.0)
    with torch.no_grad():
        for _ in range(12):
            lo = torch.where(R.eb_logits(W, lo) > target, lo * 2.0, lo)
            hi = torch.where(R.eb_logits(W, hi) < target, hi * 2.0, hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            below = R.eb_logits(W, mid) < target
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def reference_weights(cfg: dict, root, device, ref=None) -> dict:
    """The configuration's weights (float32, on ``device``), made from its
    ``weights_seed``."""
    with C.float32_numerics():
        return _make(cfg, root, device)


def _make(cfg: dict, root, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(cfg["weights_seed"]))
    W = _init(_shapes(cfg), gen, device)
    for i, g in enumerate(cfg["groups"]):  # (means, scales): the scales' half
        W[f"param_aggregation_{i}.Conv_2.Conv_0.bias"][g:] = float(cfg["scale_bias"])
    y0, y1, x0, x1 = cfg["prior_fit_crop"]
    crop = torch.from_numpy(load_photo(root / cfg["prior_fit_photo"])[:, y0:y1, x0:x1].copy())
    with torch.no_grad():
        z = R.to_eb(R.h_a(W, R.g_a(W, crop.to(device).permute(0, 3, 1, 2))))
    density = [k for k in W if k.startswith("entropy_bottleneck.") and not k.endswith("quantiles")]
    for k in density:
        W[k].requires_grad_(True)
    opt = torch.optim.Adam([W[k] for k in density], lr=float(cfg["prior_fit_lr"]))
    for _ in range(int(cfg["prior_fit_steps"])):
        u = torch.rand(z.shape, generator=gen, device=device) - 0.5
        loss = -torch.log2(R.eb_likelihood(W, z + u)).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    W = {k: v.detach() for k, v in W.items()}
    W["entropy_bottleneck.quantiles"] = _refit_quantiles(W)
    return W


def serving(cfg: dict, root, device, weights, compute_dtype=None):
    from hyres_tpu_torch.models.elic import LightWeightELIC
    from hyres_tpu_torch.models.elic_codec import ElicCodec

    model = LightWeightELIC(cfg["N"], cfg["M"], tuple(cfg["groups"]), compute_dtype=compute_dtype)
    model.load_state_dict(weights)
    codec = ElicCodec(model, coder=cfg["coder"], device=device)
    codec.update()
    return codec


def decompress(codec, compressed: dict):
    """The public decompress call -> (x_hat, decoded symbols)."""
    d = codec.decompress(compressed["strings"], compressed["shape"], compressed.get("size"))
    return d["x_hat"], d["symbols"]
