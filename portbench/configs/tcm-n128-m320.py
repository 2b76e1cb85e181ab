"""TCM at N=128, M=320 (arXiv:2303.14978), on weights that the benchmark
makes on the device from the configuration's fixed seed.

No trained TCM checkpoint exists here, so the weights follow ELIC's recipe
(``elic-n192-m320.py``, whose quantile solve this file reuses; listed
under ``assumed``): every convolution and dense kernel a normal truncated
to +-2 sigma with variance 1/fan-in, zero biases, GDN at beta 1 and gamma
0.1 I, LayerNorms at 1 and 0, the relative-position tables at stddev
0.02, each slice's scale stack's output bias at ``scale_bias``, and the
factorized prior fitted to the z of a crop of the photo. The same weights
go to the program and to the reference.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from portbench.counts import window_attn
from portbench.lib import spec
from portbench.lib.png import load_photo
from portbench.reference import common as C
from portbench.reference import nets as R

_ELIC = spec.load_module(Path(__file__).with_name("elic-n192-m320.py"))
_TRUNC_STD = 0.87962566103423978  # stddev of a unit normal truncated to [-2, 2]
REL_STD = 0.02
KEYS = ("N", "M", "window", "z_channels", "swatten_inter")  # the program's other widths are fixed


def _model(cfg: dict):
    from hyres_tpu_torch.models import TCM

    return TCM(**{k: int(cfg[k]) for k in KEYS})


def _init(shapes: dict, gen: torch.Generator, device) -> dict:
    """Initial weights: the kernels' and the relative-position tables'
    truncated normals from one uniform draw, the rest as ELIC's."""
    drawn = [k for k, s in shapes.items() if (k.endswith(".weight") and len(s) in (2, 4))
             or k.endswith("relative_position_params")]
    u = torch.rand(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=device)
    a, b = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    t = torch.clamp(math.sqrt(2) * torch.erfinv(u * (b - a) + a), -2.0, 2.0)
    W, o = {}, 0
    for k in drawn:
        s = shapes[k]
        n = math.prod(s)
        rel = k.endswith("relative_position_params")
        std = REL_STD if rel else math.sqrt(1.0 / math.prod(s[1:]))
        W[k] = (t[o:o + n] * (std / _TRUNC_STD)).reshape(s)
        o += n
    rest = {k: s for k, s in shapes.items() if k not in W}
    for k, s in list(rest.items()):
        if k.endswith(".scale"):  # LayerNorm
            W[k] = torch.ones(s, device=device)
            del rest[k]
    W.update(_ELIC._init(rest, gen, device))
    return W


def reference_weights(cfg: dict, root, device, ref) -> dict:
    """The configuration's weights (float32, on ``device``), made from its
    ``weights_seed``."""
    with C.float32_numerics():
        W = _make(cfg, root, device, ref)
    window_attn.bind(cfg, ref, W)  # for the window_attn_roofline.* readers
    return W


def _make(cfg: dict, root, device, ref) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(cfg["weights_seed"]))
    W = _init({k: tuple(v.shape) for k, v in _model(cfg).state_dict().items()}, gen, device)
    for k in W:  # the blocks' joining convolutions, whose sum with the input compounds
        if k.endswith(".Conv_1.Conv_0.weight") and ".ConvTransBlock_" in k:
            W[k] *= float(cfg["residual_scale"])
    for i in range(int(cfg["slices"])):
        W[f"cc_scale_{i}.Conv_2.Conv_0.bias"][:] = float(cfg["scale_bias"])
    y0, y1, x0, x1 = cfg["prior_fit_crop"]
    crop = torch.from_numpy(load_photo(root / cfg["prior_fit_photo"])[:, y0:y1, x0:x1].copy())
    r = ref.Reference(cfg, W)
    with torch.no_grad():
        z = R.to_eb(r.h_a(r.g_a(crop.to(device).permute(0, 3, 1, 2))))
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
    W["entropy_bottleneck.quantiles"] = _ELIC._refit_quantiles(W)
    return W


def serving(cfg: dict, root, device, weights, compute_dtype=None):
    from hyres_tpu_torch.models import TcmCodec

    if compute_dtype is not None:
        raise ValueError("TCM serves in float32 only")
    model = _model(cfg)
    model.load_state_dict(weights)
    codec = TcmCodec(model, coder=cfg["coder"], device=device)
    codec.update()
    return codec


def decompress(codec, compressed: dict):
    """The public decompress call -> (x_hat, decoded symbols); then K7's
    launches so far kept for the window_attn_roofline.* readers."""
    d = codec.decompress(compressed["strings"], compressed["shape"], compressed.get("size"))
    window_attn.mark()
    return d["x_hat"], d["symbols"]
