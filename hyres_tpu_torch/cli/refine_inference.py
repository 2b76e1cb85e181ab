"""Refinement inference CLI: one PNG through the codec's training forward.

Counterpart of ``hyres_tpu/cli/refine_inference.py``, with the same
flags plus ``--device`` (``cuda``, the default, or ``cpu``). It loads a
codec checkpoint of either package, overlays a refine-only checkpoint
with ``--post-checkpoint``, runs the deterministic training forward
(``noisequant=False``, the exact JPEG rate), writes the reconstruction
as a PNG and prints its PSNR and the JPEG layer's bpp.
``--skip-postprocessing`` writes ``clip(jpeg_decoded + residual_hat, 0,
1)``, the reconstruction before the refinement.

    python -m hyres_tpu_torch.cli.refine_inference --device cuda \\
        --checkpoint artifacts/hyres_n128_q1_l0032.msgpack \\
        --post-checkpoint refine/refine_best_99.msgpack --input in.png --output out.png
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HyRES refine inference on the PyTorch port")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--post-checkpoint", type=str, default=None,
                   help="refine-only checkpoint overlay")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, default="./refined.png")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=192)
    p.add_argument("--jpeg-quality", type=int, default=1)
    p.add_argument("--skip-postprocessing", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (for tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..models.hyres import ResidualJPEGCompression
    from ..train import load_checkpoint, load_image, restore_into, save_image
    from ..utils.device import resolve_device
    from .refine_training import load_refine

    device = resolve_device(args.device)
    model = ResidualJPEGCompression(args.N, args.M, args.jpeg_quality)
    restore_into(model, load_checkpoint(args.checkpoint))
    if args.post_checkpoint:
        load_refine(model, load_checkpoint(args.post_checkpoint))
    model.to(device).eval()
    x = torch.from_numpy(load_image(args.input)).to(device)
    with torch.no_grad():
        out = model(x, noisequant=False)
    if args.skip_postprocessing:
        x_hat = torch.clamp(out["jpeg_decoded"] + out["residual_hat"], 0, 1)
    else:
        x_hat = out["x_hat"]

    save_image(x_hat, args.output)
    mse = float(torch.mean((x - x_hat) ** 2))
    print(f"saved {args.output} psnr={-10 * np.log10(mse):.2f} "
          f"jpeg_bpp={float(out['jpeg_bpp_loss']):.4f}")


if __name__ == "__main__":
    main()
