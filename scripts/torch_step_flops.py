#!/usr/bin/env python3
"""Convolution and matmul FLOPs of the port's training steps at the recipe.

    python scripts/torch_step_flops.py [--batch 16] [--patch 256]

Counts with ``torch.utils.flop_counter.FlopCounterMode`` on the CPU, on
one 128x128 image of ``ResidualJPEGCompression(128, 192, 1)`` (random
weights: the count depends on shapes only), and scales by batch x
(patch / 128)^2, which is exact for these networks (every layer's output
grows with the pixel count; the shapes divide by 64). Prints one JSON
object in TFLOP for:

- ``rd_step``: the RD step's forward and backward (every parameter);
- ``refine_step``: the refinement step's deterministic forward and the
  backward into the refinement alone (the codec frozen);
- ``vgg_term``: the VGG16 perceptual term added to a step (``VGGLoss`` of
  x_hat and the target, forward, and its backward into x_hat).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIDE = 128


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--patch", type=int, default=256)
    args = p.parse_args(argv)

    from hyres_tpu_torch.cli.refine_training import freeze_codec
    from hyres_tpu_torch.losses import VGGLoss, rate_distortion_loss
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression

    torch.manual_seed(0)
    x = torch.rand(1, SIDE, SIDE, 3)

    def rd():
        model = ResidualJPEGCompression(128, 192, 1)
        out = model(x, noisequant=True, generator=torch.Generator().manual_seed(0))
        rate_distortion_loss(out, x, 0.015, 0.0)["loss"].backward()

    def refine():
        model = ResidualJPEGCompression(128, 192, 1)
        freeze_codec(model)
        out = model(x, noisequant=False)
        (torch.mean((out["x_hat"] - x) ** 2) * 255.0 ** 2).backward()

    vgg = VGGLoss()

    def vgg_term():
        x_hat = x.clone().requires_grad_()
        vgg(x_hat, x).backward()

    scale = args.batch * (args.patch / SIDE) ** 2
    out = {k: _count(fn) * scale / 1e12
           for k, fn in (("rd_step", rd), ("refine_step", refine), ("vgg_term", vgg_term))}
    out.update({"batch": args.batch, "patch": args.patch, "unit": "TFLOP"})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
