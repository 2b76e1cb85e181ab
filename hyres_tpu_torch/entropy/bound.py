"""Lower bound used by the entropy models, with its custom gradient.

Counterpart of ``hyres_tpu/entropy/bound.py`` (``jax.custom_vjp``, ``:18-33``):
the forward is ``max(x, bound)``; the backward passes the gradient where
the input is at or above the bound OR where the gradient would push the
input upward (``g < 0`` under gradient descent), so a clamped value can
still leave the bound. No gradient flows to the bound.
"""

from __future__ import annotations

import torch

LIKELIHOOD_BOUND = 1e-9


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        # A Python bound stays a scalar argument of the op, so no host value
        # is copied to the card (and nothing synchronises).
        if torch.is_tensor(bound):
            return torch.maximum(x, bound.to(x.dtype))
        return torch.clamp_min(x, float(bound))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        b = ctx.bound
        above = x >= (b.to(x.dtype) if torch.is_tensor(b) else float(b))
        return torch.where(above | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    """max(x, bound) with the pass-through gradient."""
    return _LowerBound.apply(x, bound)
