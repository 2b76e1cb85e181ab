"""Discretized Gaussian mixture likelihood (Cheng et al. 2020,
arXiv:2001.01568).

Each latent element is coded against
``p(q) = sum_k w_k [Phi((q + 1/2 - mu_k) / s_k) - Phi((q - 1/2 - mu_k) / s_k)]``
with ``w = softmax(logits)`` and ``s_k >= 0.11``. ``gmm_likelihood`` is
that probability of the continuous ``y`` in float32, floored as
``gaussian_likelihood`` floors it. The device coder's integer rows of the
same mixture are K6's (``kernels/rans.py gmm_rows``).
"""

from __future__ import annotations

import torch

from .bound import LIKELIHOOD_BOUND, lower_bound
from .gaussian import SCALES_MIN, _std_cumulative



def split_params(p: torch.Tensor, K: int):
    """(..., 3 K M) -> (logits, means, scales), each (..., K, M): the
    channels are K blocks of M logits, then of means, then of scales."""
    M = p.shape[-1] // (3 * K)
    return p.unflatten(-1, (3, K, M)).unbind(-3)


def gmm_likelihood(y: torch.Tensor, logits: torch.Tensor, means: torch.Tensor,
                   scales: torch.Tensor, scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """P(round(y)) under the mixture, per element of ``y`` (..., M); the
    parameters (..., K, M). float32, bounded below like
    ``gaussian_likelihood``."""
    y = y.to(torch.float32)[..., None, :]
    w = torch.softmax(logits.to(torch.float32), dim=-2)
    s = lower_bound(scales.to(torch.float32), scale_bound)
    v = torch.abs(y - means.to(torch.float32))
    p = _std_cumulative((0.5 - v) / s) - _std_cumulative((-0.5 - v) / s)
    return lower_bound((w * p).sum(-2), LIKELIHOOD_BOUND)
