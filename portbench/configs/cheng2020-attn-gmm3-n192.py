"""Cheng2020 with attention and a 3-component Gaussian mixture at N = M =
192 (arXiv:2001.01568), on weights that the benchmark makes on the device
from the configuration's fixed seed.

No trained checkpoint exists here, so the weights follow ELIC's recipe
(``elic-n192-m320.py``, whose initialiser and quantile solve this file
reuses; listed under ``assumed``): flax's initialisers, the scale
channels' output bias at ``scale_bias``, each component's mean channels'
at its ``mean_bias`` (the mixture logits' bias stays 0), and the
factorized prior fitted to the z of a crop of the photo. The
same weights go to the program and to the reference.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.lib import spec
from portbench.lib.png import load_photo
from portbench.reference import common as C
from portbench.reference import nets as R

_ELIC = spec.load_module(Path(__file__).with_name("elic-n192-m320.py"))


def _model(cfg: dict, compute_dtype=None):
    from hyres_tpu_torch.models import Cheng2020withCheckerboard

    return Cheng2020withCheckerboard(cfg["N"], compute_dtype=compute_dtype,
                                     attention=bool(cfg["attention"]),
                                     mixtures=int(cfg["mixtures"]))


def reference_weights(cfg: dict, root, device, ref) -> dict:
    """The configuration's weights (float32, on ``device``), made from its
    ``weights_seed``."""
    with C.float32_numerics():
        return _make(cfg, root, device, ref)


def _make(cfg: dict, root, device, ref) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(cfg["weights_seed"]))
    shapes = {k: tuple(v.shape) for k, v in _model(cfg).state_dict().items()}
    W = _ELIC._init(shapes, gen, device)
    M, K = int(cfg["M"]), int(cfg["mixtures"])
    bias = W["entropy_parameters.Conv_2.Conv_0.bias"]  # K blocks each of logits, means, scales
    for k, mean in enumerate(cfg["mean_bias"]):
        bias[(K + k) * M:(K + k + 1) * M] = float(mean)
    bias[2 * K * M:] = float(cfg["scale_bias"])
    y0, y1, x0, x1 = cfg["prior_fit_crop"]
    crop = torch.from_numpy(load_photo(root / cfg["prior_fit_photo"])[:, y0:y1, x0:x1].copy())
    with torch.no_grad():
        z = R.to_eb(ref.h_a(W, ref.g_a(W, crop.to(device).permute(0, 3, 1, 2))))
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
    from hyres_tpu_torch.models import Cheng2020Codec

    model = _model(cfg, compute_dtype)
    model.load_state_dict(weights)
    codec = Cheng2020Codec(model, coder=cfg["coder"], device=device)
    codec.update()
    return codec


def decompress(codec, compressed: dict):
    """The public decompress call -> (x_hat, decoded symbols)."""
    d = codec.decompress(compressed["strings"], compressed["shape"], compressed.get("size"))
    return d["x_hat"], d["symbols"]
