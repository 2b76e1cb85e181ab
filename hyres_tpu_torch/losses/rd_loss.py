"""Rate-distortion loss (counterpart of ``hyres_tpu/losses/rd_loss.py:18-45``).

``loss = lambda * MSE * 255^2 + bpp + alpha * VGG * 255^2``, where bpp is
the residual codec's rate (-log2 likelihood sums over the pixel count)
plus the observed JPEG rate (a constant to the parameters). The dict of
eight terms is the reference's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def rate_distortion_loss(output: Dict, target: torch.Tensor, lmbda: float = 0.004,
                         alpha: float = 0.001, vgg_fn: Callable | None = None) -> Dict:
    B, H, W, _ = target.shape
    num_pixels = B * H * W
    log2 = math.log(2.0)
    y_bpp = -torch.sum(torch.log(output["likelihoods"]["y"])) / (log2 * num_pixels)
    z_bpp = -torch.sum(torch.log(output["likelihoods"]["z"])) / (log2 * num_pixels)
    residual_bpp = y_bpp + z_bpp
    jpeg_bpp = output.get("jpeg_bpp_loss")
    if jpeg_bpp is None:
        jpeg_bpp = torch.zeros((), device=target.device)
    bpp = residual_bpp + jpeg_bpp
    mse = torch.mean((output["x_hat"] - target) ** 2) * 255.0 ** 2
    if vgg_fn is not None and alpha != 0:
        vgg = vgg_fn(output["x_hat"], target) * 255.0 ** 2
    else:
        vgg = torch.zeros((), device=target.device)
    loss = lmbda * mse + bpp + alpha * vgg
    return {"loss": loss, "mse_loss": mse, "vgg_loss": vgg, "bpp_loss": bpp,
            "residual_bpp_loss": residual_bpp, "jpeg_bpp_loss": jpeg_bpp,
            "y_bpp_loss": y_bpp, "z_bpp_loss": z_bpp}
