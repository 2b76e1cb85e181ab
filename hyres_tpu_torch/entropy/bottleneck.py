"""Factorized prior over the hyper-latent z.

Counterpart of ``hyres_tpu/entropy/bottleneck.py``: the learned density
parameters (``matrix_k``/``bias_k``/``factor_k``/``quantiles``, stored
and initialised as the reference does, ``:68-96``), the training
likelihood on noise- or median-rounded values (``:112-135``), the
quantile-fitting ``aux_loss`` (``:137-146``), per-channel ``medians``,
the host bake ``build_bottleneck_tables`` (``:199``) with the
overflow-guarded ``_sigmoid`` (``:241``), and the closed-form quantile
refit ``refit_quantiles``/``refit_model_quantiles`` (``:148``, ``:256``)
that the CLIs apply to raw training checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..nn import quantizer
from .bound import LIKELIHOOD_BOUND, lower_bound


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF tables consumed by the rANS coder (int32 numpy)."""

    quantized_cdf: np.ndarray  # (rows, max_len)
    cdf_length: np.ndarray     # (rows,)
    offset: np.ndarray         # (rows,)


def _logits_cumulative(params: dict, x: torch.Tensor,
                       stop_gradient: bool = False) -> torch.Tensor:
    """Logit of the learned CDF at ``x`` (shape (C, 1, N)), float32. With
    ``stop_gradient`` the density parameters are detached."""
    num_filters = len([k for k in params if k.startswith("matrix_")])
    for k in range(num_filters):
        m, b = params[f"matrix_{k}"], params[f"bias_{k}"]
        if stop_gradient:
            m, b = m.detach(), b.detach()
        x = torch.einsum("coi,cin->con", F.softplus(m), x) + b
        if f"factor_{k}" in params:
            f = params[f"factor_{k}"]
            x = x + torch.tanh(f.detach() if stop_gradient else f) * torch.tanh(x)
    return x


class EntropyBottleneck(nn.Module):
    """Factorized prior over z, its parameters under the reference's names.
    ``forward`` returns ``(z_hat, likelihoods)``, both NHWC like ``z``."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9):
        super().__init__()
        self.filters, self.init_scale, self.tail_mass = tuple(filters), init_scale, tail_mass
        dims = (1,) + self.filters + (1,)
        for k in range(len(filters) + 1):
            self.register_parameter(
                f"matrix_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], dims[k])))
            self.register_parameter(
                f"bias_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1)))
            if k < len(filters):
                self.register_parameter(
                    f"factor_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The reference's initialisers: matrix ``log(expm1(1/scale/f))``,
        bias U(-0.5, 0.5), factor 0, quantiles [-s, 0, s]."""
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        for k in range(len(self.filters) + 1):
            getattr(self, f"matrix_{k}").fill_(math.log(math.expm1(1.0 / scale / dims[k + 1])))
            bias = getattr(self, f"bias_{k}")
            bias.copy_(torch.rand(bias.shape, generator=generator, device=bias.device) - 0.5)
            if k < len(self.filters):
                getattr(self, f"factor_{k}").zero_()
        self.quantiles.copy_(torch.tensor([-self.init_scale, 0.0, self.init_scale])
                             .expand_as(self.quantiles))

    def _density(self) -> dict:
        return {k: v for k, v in self.named_parameters(recurse=False) if k != "quantiles"}

    def medians(self) -> torch.Tensor:
        """Per-channel learned medians, shape (C,)."""
        return self.quantiles[:, 0, 1].detach()

    def _likelihood(self, v: torch.Tensor) -> torch.Tensor:
        """v: (C, 1, N). Stable sigmoid-difference likelihood."""
        p = self._density()
        lower = _logits_cumulative(p, v - 0.5)
        upper = _logits_cumulative(p, v + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def noise_shape(self, z_shape) -> tuple:
        """Shape of the noise draw for a z of NHWC ``z_shape``: the (C, 1,
        B*H*W) layout the density runs in."""
        B, H, W, C = z_shape
        return (C, 1, B * H * W)

    def forward(self, z: torch.Tensor, noise: bool = True,
                generator: torch.Generator | None = None,
                u: torch.Tensor | None = None):
        """z: NHWC. ``noise`` adds U(-0.5, 0.5) (the draw ``u``, else one
        from ``generator``); otherwise z rounds about the detached medians."""
        B, H, W, C = z.shape
        v = z.to(torch.float32).permute(3, 0, 1, 2).reshape(C, 1, B * H * W)
        if noise:
            if u is None:
                u = quantizer.uniform_noise(v.shape, generator, v.device)
            v_hat = v + u
        else:
            med = self.medians().reshape(C, 1, 1)
            v_hat = torch.round(v - med) + med
        lik = lower_bound(self._likelihood(v_hat), LIKELIHOOD_BOUND)
        z_hat = v_hat.reshape(C, B, H, W).permute(1, 2, 3, 0)
        return z_hat, lik.reshape(C, B, H, W).permute(1, 2, 3, 0)

    def aux_loss(self) -> torch.Tensor:
        """Quantile-fitting loss: the logits at the quantiles run through
        detached density parameters, so only ``quantiles`` get a gradient."""
        logits = _logits_cumulative(self._density(), self.quantiles, stop_gradient=True)
        t = math.log(2.0 / self.tail_mass - 1.0)
        # [-t, 0, t] made on the device (no upload)
        target = (torch.arange(-1, 2, dtype=torch.float32, device=logits.device)
                  * t).reshape(1, 1, 3)
        return torch.sum(torch.abs(logits - target))

    def param_dict(self) -> dict:
        """numpy copies of the parameters, as ``build_bottleneck_tables``
        takes them."""
        return {k: v.detach().cpu().numpy() for k, v in self.named_parameters()}


def build_bottleneck_tables(eb_params: dict, tail_mass: float = 1e-9) -> CdfTables:
    """Bake per-channel quantized CDFs from learned density params (host).

    Integer support from the learned quantiles, PMF from the density in
    float32, tail mass appended, then quantized to 16-bit CDFs.
    """
    from ..coding.cdf import pmf_to_quantized_cdf

    q = np.asarray(eb_params["quantiles"])  # (C,1,3)
    medians = q[:, 0, 1]
    minima = np.maximum(np.ceil(medians - q[:, 0, 0]).astype(np.int32), 0)
    maxima = np.maximum(np.ceil(q[:, 0, 2] - medians).astype(np.int32), 0)
    pmf_length = (minima + maxima + 1).astype(np.int32)
    max_length = int(pmf_length.max())
    C = medians.shape[0]

    samples = np.arange(max_length, dtype=np.float32)[None, :] + (medians - minima)[:, None]
    v = torch.from_numpy(samples.reshape(C, 1, max_length).astype(np.float32))
    p = {k: torch.from_numpy(np.array(val, np.float32))
         for k, val in eb_params.items() if k != "quantiles"}
    with torch.no_grad():
        lower = _logits_cumulative(p, v - 0.5).numpy()
        upper = _logits_cumulative(p, v + 0.5).numpy()
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]

    cdfs = np.zeros((C, max_length + 2), np.int32)
    for c in range(C):
        n = int(pmf_length[c])
        # mass left of the support + mass right of it goes into one escape bin
        tail = _sigmoid(lower[c, 0, 0]) + _sigmoid(-upper[c, 0, n - 1])
        row = pmf_to_quantized_cdf(
            np.concatenate([pmf[c, :n], [max(tail, 0.0)]]).astype(np.float32))
        cdfs[c, : len(row)] = row
    return CdfTables(quantized_cdf=cdfs, cdf_length=pmf_length + 2,
                     offset=-minima)


def _sigmoid(x):
    """Overflow-guarded logistic for the CDF bake: equal to the naive
    1/(1+exp(-x)) wherever that is finite, and an exact 0.0 (without an
    overflow warning) where exp(-x) would overflow."""
    x = np.asarray(x, np.float64)
    safe = x >= -709.782712893384  # -log(DBL_MAX): exp(-x) still finite
    e = np.exp(-np.where(safe, x, 0.0))
    return np.where(safe, 1.0 / (1.0 + e), 0.0)


def refit_quantiles(eb_params: dict, tail_mass: float = 1e-9,
                    iters: int = 80) -> np.ndarray:
    """The quantiles solved from the learned density by bisection: the x
    where the CDF logit reaches [-t, 0, t], t = log(2 / tail_mass - 1).
    The logit is monotone in x (softplus-positive weights, bounded tanh
    gating), so the bracket expansion and bisection always converge.
    Returns a (C, 1, 3) float32 array; ``eb_params`` is not modified."""
    t = math.log(2.0 / tail_mass - 1.0)
    target = torch.tensor([-t, 0.0, t], dtype=torch.float32).reshape(1, 1, 3)
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in eb_params.items()
         if k != "quantiles"}
    C = p["bias_0"].shape[0]
    with torch.no_grad():
        # expand the bracket until it straddles the targets everywhere
        lo = torch.full((C, 1, 3), -1.0)
        hi = torch.full((C, 1, 3), 1.0)
        for _ in range(12):  # up to +/- 4096
            f_lo = _logits_cumulative(p, lo)
            f_hi = _logits_cumulative(p, hi)
            lo = torch.where(f_lo > target, lo * 2.0, lo)
            hi = torch.where(f_hi < target, hi * 2.0, hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            below = _logits_cumulative(p, mid) < target
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
    return (0.5 * (lo + hi)).numpy().astype(np.float32)


def refit_model_quantiles(variables: dict) -> dict:
    """A copy of a params tree with every ``entropy_bottleneck``'s
    quantiles refit from its density (``refit_quantiles``), so the baked
    integer support never depends on how far the aux optimizer got."""
    def walk(key, node):
        if not isinstance(node, dict):
            return node
        if key == "entropy_bottleneck" and "quantiles" in node:
            return {**node, "quantiles": refit_quantiles(node)}
        return {k: walk(k, v) for k, v in node.items()}

    return walk(None, variables)
