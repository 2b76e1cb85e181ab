"""Quantization modes (counterpart of ``hyres_tpu/nn/quantizer.py`` and the
quantize helpers of ``hyres_tpu/entropy/gaussian.py:63-70``).

``noise``: additive U(-0.5, 0.5); ``ste``: straight-through round;
otherwise a hard round. Every training draw of the port goes through
``uniform_noise`` with an explicit ``torch.Generator``, so a caller (a
test, or the train step ahead of a checkpointed forward) controls it.
"""

from __future__ import annotations

import torch


def uniform_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """float32 U(-0.5, 0.5) noise of ``shape`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) - 0.5


def ste(x: torch.Tensor) -> torch.Tensor:
    """Round in the forward, identity in the backward."""
    return x + (torch.round(x) - x).detach()


def quantize(x: torch.Tensor, mode: str = "noise", noise: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``noise`` adds the given U(-0.5, 0.5) draw; ``ste`` rounds
    straight-through; anything else rounds."""
    if mode == "noise":
        if noise is None:
            raise ValueError("noise quantization needs a noise draw")
        return x + noise.to(x.dtype)
    if mode == "ste":
        return ste(x)
    return torch.round(x)
