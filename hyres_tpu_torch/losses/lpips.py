"""LPIPS distance with the AlexNet trunk (counterpart of
``hyres_tpu/losses/lpips.py``).

The public construction of Zhang et al. (2018): inputs in [0, 1] go to
[-1, 1] and through the shift/scale whitening; AlexNet's five
convolutions (11x11 stride 4 pad 2, 5x5 pad 2, then three 3x3 pad 1,
a 3x3 stride-2 max-pool after the first two relus) are tapped after each
relu; each tap is unit-normalised over channels (eps 1e-10 on the norm),
the squared difference weighted by that tap's non-negative 1x1 head
``lin{i}``, averaged over space and summed over the taps; the batch's
mean is the distance.

Weights come only from ``HYRES_LPIPS_WEIGHTS``, a ``.npz`` in the torch
layout (``net.conv{i}.weight`` (O, I, kH, kW), ``net.conv{i}.bias``,
``lin{i}.weight`` (1, C, 1, 1)), which is this module's own state-dict
layout. Nothing is downloaded; without the file ``load_lpips`` gives
None.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import _Conv2d

# (out channels, kernel, stride, pad) of torchvision's alexnet.features
_ALEX_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
             (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}  # 3x3 stride-2 max-pool after these convolutions

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexFeatures(nn.Module):
    """AlexNet feature trunk on NCHW input; returns the five post-relu
    activations."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, p) in enumerate(_ALEX_CFG):
            setattr(self, f"conv{i}", _Conv2d(cin, ch, k, s, p))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(len(_ALEX_CFG)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            outs.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return outs


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """Frozen LPIPS distance: ``lpips(x, y)`` on NHWC [0, 1] batches, the
    batch's mean. Raises FileNotFoundError without a weights file. Built
    on the CPU; move it with ``.to(device)``."""

    def __init__(self, weights_path: str):
        super().__init__()
        if not weights_path or not os.path.exists(weights_path):
            raise FileNotFoundError(weights_path)
        self.net = AlexFeatures()
        for i, (ch, _, _, _) in enumerate(_ALEX_CFG):
            setattr(self, f"lin{i}", _Conv2d(ch, 1, 1, bias=False))
        raw = np.load(weights_path)
        self.load_state_dict({k: torch.from_numpy(np.asarray(raw[k], np.float32))
                              for k in self.state_dict()}, strict=True)
        self.requires_grad_(False)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.eval()

    def _prep(self, v: torch.Tensor) -> torch.Tensor:
        return (2.0 * v.float().permute(0, 3, 1, 2) - 1.0 - self.shift) / self.scale

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx, fy = self.net(self._prep(x)), self.net(self._prep(y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = getattr(self, f"lin{i}").weight.view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return torch.mean(total)


def load_lpips() -> LPIPS | None:
    """An LPIPS module (on the CPU) where ``HYRES_LPIPS_WEIGHTS`` names an
    existing weights file, else None."""
    path = os.environ.get("HYRES_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    return LPIPS(path)
