"""Conditional Gaussian entropy model: likelihood, scale table, symbols,
indexes.

Counterpart of ``hyres_tpu/entropy/gaussian.py``: the training
likelihood ``gaussian_likelihood`` (``:40-60``), the quantize helpers
(``:63-104``), the 64-entry log-spaced scale table, clipped int16
symbols, ``build_indexes`` and host-side CDF table baking.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special
import torch

from ..nn.quantizer import ste, uniform_noise
from .bottleneck import CdfTables
from .bound import LIKELIHOOD_BOUND, lower_bound

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64

# symbols cross the host hop as int16; the encoder clips BEFORE coding,
# so both sides always agree on the integer
SYMBOL_BOUND = 32000


def get_scale_table(smin: float = SCALES_MIN, smax: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """64 log-spaced sigmas, 0.11 -> 256."""
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels)).astype(np.float32)


def _std_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF via erfc (stable in both tails)."""
    return 0.5 * torch.special.erfc(-x * (2 ** -0.5))


def gaussian_likelihood(x: torch.Tensor, scales: torch.Tensor,
                        means: torch.Tensor | None = None,
                        scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """P(round(x) | mu, sigma) under the relaxed box integral, bounded
    below. Always float32 (erfc in bf16 collapses the rate signal)."""
    x = x.to(torch.float32)
    scales = scales.to(torch.float32)
    if means is not None:
        x = x - means.to(torch.float32)
    scales = lower_bound(scales, scale_bound)
    v = torch.abs(x)
    upper = _std_cumulative((0.5 - v) / scales)
    lower = _std_cumulative((-0.5 - v) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def quantize_noise(x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """``x`` plus U(-0.5, 0.5) noise drawn from ``generator`` (the port's
    generator, not ``jax.random``: the same seed gives other noise)."""
    return x + uniform_noise(x.shape, generator, x.device).to(x.dtype)


def quantize_ste(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round (CompressAI ``quantize_ste``)."""
    return ste(x)


def quantize_symbols(x: torch.Tensor, means: torch.Tensor | None = None) -> torch.Tensor:
    """Hard int32 symbols for the entropy coder."""
    if means is not None:
        x = x - means
    return torch.round(x).to(torch.int32)


def dequantize(symbols: torch.Tensor, means: torch.Tensor | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    out = symbols.to(dtype)
    if means is not None:
        out = out + means
    return out


def quantize_symbols_i16(x: torch.Tensor, means: torch.Tensor | None = None) -> torch.Tensor:
    """Clipped int16 symbols for the host hop (device side)."""
    if means is not None:
        x = x - means
    return torch.clamp(torch.round(x), -SYMBOL_BOUND, SYMBOL_BOUND).to(torch.int16)


def narrow_symbols_i16(sym) -> np.ndarray:
    """Host-side narrowing of decoded int32 symbols: clamp (never wrap) so
    corrupt-bitstream garbage stays detectable rather than aliasing."""
    return np.clip(sym, -SYMBOL_BOUND, SYMBOL_BOUND).astype(np.int16)


def build_indexes(scales: torch.Tensor, scale_table: torch.Tensor) -> torch.Tensor:
    """Map each sigma to the smallest table entry >= sigma (CompressAI
    ``build_indexes``): the count of entries of ``table[:-1]`` strictly
    below the lower-bounded sigma. int32, same shape as ``scales``."""
    table = scale_table.to(device=scales.device, dtype=scales.dtype)
    s = torch.maximum(scales, table[0])
    return torch.searchsorted(table[:-1].contiguous(), s.contiguous(),
                              right=False).to(torch.int32)


def build_gaussian_tables(scale_table: np.ndarray, tail_mass: float = 1e-9) -> CdfTables:
    """Bake per-scale quantized CDF tables (host, cold path)."""
    from ..coding.cdf import pmf_to_quantized_cdf

    scale_table = np.asarray(scale_table, np.float64)
    multiplier = -scipy.special.ndtri(tail_mass / 2.0)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length, dtype=np.int64)[None, :] - pmf_center[:, None])
    samples_scale = scale_table[:, None]
    upper = scipy.special.ndtr((0.5 - samples) / samples_scale)
    lower = scipy.special.ndtr((-0.5 - samples) / samples_scale)
    pmf = upper - lower
    tail = 2.0 * lower[:, :1]

    cdfs = np.zeros((len(scale_table), max_length + 2), np.int32)
    for i in range(len(scale_table)):
        n = int(pmf_length[i])
        row = pmf_to_quantized_cdf(
            np.concatenate([pmf[i, :n], tail[i]]).astype(np.float32))
        cdfs[i, : len(row)] = row
    return CdfTables(quantized_cdf=cdfs, cdf_length=pmf_length + 2,
                     offset=-pmf_center)
