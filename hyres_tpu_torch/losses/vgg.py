"""VGG16 perceptual loss (counterpart of ``hyres_tpu/losses/vgg.py``).

A frozen VGG16 feature trunk (configuration "D"), ImageNet-normalised
inputs, and the sum over five slices (after relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3) of the mean L1 distance between the two images'
activations. The trunk is torchvision's ``vgg16.features`` layout, so the
weights of ``HYRES_VGG16_WEIGHTS`` (a ``.npz`` of ``features.{i}.weight``
(O, I, kH, kW) and ``features.{i}.bias``) load as they are stored.
Nothing is downloaded: without that file the features are random, drawn
with the reference's initialisers (``lecun_normal`` kernels, zero biases)
from a seeded ``torch.Generator``. They are not the reference's random
features, which come from ``jax.random``.

The trunk's parameters never take a gradient, and the loss is no
submodule of a codec, so no optimizer or checkpoint holds them. The
gradient flows into the first image. The loss runs in float32 whatever
the codec's compute dtype.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch import nn

from ..nn.layers import _Conv2d, init_parameters

# conv output channels of torchvision's vgg16.features, "M" a 2x2 max-pool
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
# (conv + relu) units a slice consumes: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_SLICE_CONVS = [2, 2, 3, 3, 3]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """VGG16 feature trunk on NCHW input; returns the five slice
    activations. ``features`` indexes as torchvision's (conv i at the
    state-dict key ``features.{i}``)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for item in _VGG16_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [_Conv2d(cin, item, 3, 1, 1), nn.ReLU()]
            cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, slice_idx, consumed = [], 0, 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                consumed += 1
                if slice_idx < len(_SLICE_CONVS) and consumed == _SLICE_CONVS[slice_idx]:
                    outs.append(x)
                    slice_idx, consumed = slice_idx + 1, 0
        return outs


def load_vgg16_params(module: VGG16Features) -> bool:
    """Load ``HYRES_VGG16_WEIGHTS`` into ``module`` where the variable
    names an existing file; returns whether it did (pretrained)."""
    path = os.environ.get("HYRES_VGG16_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return False
    raw = np.load(path)
    keys = module.state_dict().keys()
    module.load_state_dict({k: torch.from_numpy(np.asarray(raw[k], np.float32))
                            for k in keys}, strict=True)
    return True


class VGGLoss(nn.Module):
    """Frozen perceptual loss: ``loss(x, y)`` on NHWC [0, 1] batches, a
    float32 scalar whose gradient reaches ``x``. ``pretrained`` says
    whether ``HYRES_VGG16_WEIGHTS`` was loaded. Built on the CPU; move it
    with ``.to(device)``."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.module = VGG16Features()
        init_parameters(self.module, generator if generator is not None
                        else torch.Generator().manual_seed(0))
        self.pretrained = load_vgg16_params(self.module)
        self.module.requires_grad_(False)
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1))
        self.eval()

    def _prep(self, v: torch.Tensor) -> torch.Tensor:
        return (v.float().permute(0, 3, 1, 2) - self.mean) / self.std

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.module(self._prep(x))
        with torch.no_grad():
            fy = self.module(self._prep(y))
        loss = torch.zeros((), device=x.device)
        for a, b in zip(fx, fy):
            loss = loss + torch.mean(torch.abs(a - b))
        return loss


__all__ = ["VGG16Features", "VGGLoss", "load_vgg16_params"]
