"""Evaluation metrics: PSNR, MS-SSIM and ``CompressionMetrics``.

Counterpart of ``hyres_tpu/losses/metrics.py:26-99``: PSNR for [0, 1]
data, and the multi-scale SSIM of Wang et al. with the 11x11 sigma-1.5
Gaussian window, the variance form E[x^2] - mu^2 clipped to [0, 1] at
every scale, 2x2 average pooling between scales and the five standard
weights. Inputs are NHWC float tensors. On the card the convolutions run
in full float32 (``utils/device.py`` turns TF32 off, and
``CompressionMetrics`` scopes it off again), as the variance cancellation
needs. ``CompressionMetrics.compute_all`` gives PSNR, MS-SSIM and LPIPS,
the last None unless ``HYRES_LPIPS_WEIGHTS`` names a weights file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean per-image PSNR for [0, 1] data."""
    mse = torch.mean((x - y) ** 2, dim=(1, 2, 3))
    return torch.mean(-10.0 * torch.log10(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - (size - 1) / 2.0) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' filtering of NCHW ``x`` with a 2-D window. Below
    the window's size the output is empty, so the mean over it is NaN, as
    in the reference."""
    B, C, H, W = x.shape
    k = win.shape[0]
    if H < k or W < k:
        return x.new_empty((B, C, max(H - k + 1, 0), max(W - k + 1, 0)))
    return F.conv2d(x, win.expand(C, 1, k, k), groups=C)


def _ssim_components(x, y, win, data_range: float = 1.0):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _filter2d(x, win)
    mu_y = _filter2d(y, win)
    sxx = _filter2d(x * x, win) - mu_x * mu_x
    syy = _filter2d(y * y, win) - mu_y * mu_y
    sxy = _filter2d(x * y, win) - mu_x * mu_y
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


@torch.no_grad()
def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM over 5 scales, averaged over the batch."""
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    win = torch.from_numpy(_gaussian_window()).to(x.device)
    vals = []
    for i in range(5):
        ssim, cs = _ssim_components(x, y, win, data_range)
        # the variance form can go slightly negative on near-identical
        # inputs, pushing cs or ssim above 1
        vals.append(torch.clamp(cs if i < 4 else ssim, 0.0, 1.0))
        if i < 4:
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    weights = torch.tensor(_MSSSIM_WEIGHTS, dtype=torch.float32, device=x.device)
    return torch.mean(torch.prod(torch.stack(vals) ** weights[:, None], dim=0))


class CompressionMetrics:
    """``compute_all(x, y) -> {"psnr", "ms-ssim", "lpips"}`` on NHWC [0, 1]
    batches (``lpips`` None unless ``HYRES_LPIPS_WEIGHTS`` is set)."""

    def __init__(self, device="cuda"):
        from ..utils.device import resolve_device
        from .lpips import load_lpips

        lp = load_lpips()
        self.lpips_fn = None if lp is None else lp.to(resolve_device(device))

    @torch.no_grad()
    def compute_all(self, x: torch.Tensor, y: torch.Tensor) -> Dict:
        from ..utils.device import full_float32

        with full_float32():
            return {"psnr": float(psnr(x, y)), "ms-ssim": float(ms_ssim(x, y)),
                    "lpips": None if self.lpips_fn is None else float(self.lpips_fn(x, y))}
