"""Lower bound used by the entropy models (forward only).

Counterpart of ``hyres_tpu/entropy/bound.py``. This slice runs inference
only, so the custom gradient of the reference (pass-through when the
gradient pushes upward) waits for the training slice.
"""

from __future__ import annotations

import torch

LIKELIHOOD_BOUND = 1e-9


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    """max(x, bound). A Python bound stays a scalar argument of the op, so
    no host value is copied to the card (and nothing synchronises)."""
    if torch.is_tensor(bound):
        return torch.maximum(x, bound.to(x.dtype))
    return torch.clamp_min(x, float(bound))
