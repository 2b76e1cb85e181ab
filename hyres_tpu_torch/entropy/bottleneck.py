"""Factorized prior over the hyper-latent z (inference half).

Counterpart of ``hyres_tpu/entropy/bottleneck.py``: the learned density
parameters (``matrix_k``/``bias_k``/``factor_k``/``quantiles``, stored
as the reference stores them), per-channel ``medians``, the host bake
``build_bottleneck_tables`` (``:199``) with the overflow-guarded
``_sigmoid`` (``:241``), and the closed-form quantile refit
``refit_quantiles``/``refit_model_quantiles`` (``:148``, ``:256``) that
the CLIs apply to raw training checkpoints. The training likelihood and
aux loss wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF tables consumed by the rANS coder (int32 numpy)."""

    quantized_cdf: np.ndarray  # (rows, max_len)
    cdf_length: np.ndarray     # (rows,)
    offset: np.ndarray         # (rows,)


def _logits_cumulative(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logit of the learned CDF at ``x`` (shape (C, 1, N)), float32."""
    num_filters = len([k for k in params if k.startswith("matrix_")])
    for k in range(num_filters):
        m = params[f"matrix_{k}"]
        x = torch.einsum("coi,cin->con", F.softplus(m), x) + params[f"bias_{k}"]
        if f"factor_{k}" in params:
            x = x + torch.tanh(params[f"factor_{k}"]) * torch.tanh(x)
    return x


class EntropyBottleneck(nn.Module):
    """Holds the factorized prior's parameters under the reference's names."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3)):
        super().__init__()
        dims = (1,) + tuple(filters) + (1,)
        for k in range(len(filters) + 1):
            self.register_parameter(
                f"matrix_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], dims[k])))
            self.register_parameter(
                f"bias_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1)))
            if k < len(filters):
                self.register_parameter(
                    f"factor_{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1)))
        self.quantiles = nn.Parameter(torch.zeros(channels, 1, 3))

    def medians(self) -> torch.Tensor:
        """Per-channel learned medians, shape (C,)."""
        return self.quantiles[:, 0, 1].detach()

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
