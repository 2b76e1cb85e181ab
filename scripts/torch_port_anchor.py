"""Quality anchor for the PyTorch port, computed with the JAX reference.

Runs ``hyres_tpu.models.hyres.HyresCodec`` in float32 with the trained
artifact's weights and baked tables on one image, with the host rANS
coder (``--coder host``) or the device coder (``--coder tpu``, which the
JAX package runs as XLA scans on the CPU), and prints its bpp (from real
byte lengths), PSNR and host-coder fallbacks as one JSON line. The port's
``chip_smoke.py`` holds its own f32 numbers on the same image against
these. This measures rate and quality, not speed.

    JAX_PLATFORMS=cpu python scripts/torch_port_anchor.py [--coder tpu] \
        [--image matched_r5/hyres_found/best_images/0_original.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax
import numpy as np
from PIL import Image

from hyres_tpu.models import codec as jcodec
from hyres_tpu.models.hyres import HyresCodec, ResidualJPEGCompression
from hyres_tpu.train.checkpoint import extract_variables, load_checkpoint

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact",
                    default=str(ROOT / "artifacts/hyres_n128_q1_l0032.msgpack"))
    ap.add_argument("--image", default=str(
        ROOT / "matched_r5/hyres_found/best_images/0_original.png"))
    ap.add_argument("--coder", choices=("host", "tpu"), default="host")
    args = ap.parse_args()

    raw = load_checkpoint(args.artifact)
    cfg = {k: int(v) for k, v in raw["config"].items()}
    model = ResidualJPEGCompression(N=cfg["N"], M=cfg["M"],
                                    jpeg_quality=cfg["jpeg_quality"])
    codec = HyresCodec(model, extract_variables(raw), coder=args.coder)
    codec.install_tables(raw["tables"])

    x = np.asarray(Image.open(args.image).convert("RGB"), np.float32)[None] / 255.0
    jcodec.reset_wire_stats()
    comp = codec.compress(jax.numpy.asarray(x))
    x_hat = np.asarray(codec.decompress(comp)["x_hat"])
    nbytes = (sum(len(b) for b in comp["jpeg_buffers"])
              + sum(len(s) for part in comp["strings"][0] for s in part)
              + sum(len(s) for s in comp["strings"][1]))
    h, w = x.shape[1:3]
    mse = float(np.mean((x_hat.astype(np.float64) - x) ** 2))
    print(json.dumps({
        "image": str(Path(args.image).relative_to(ROOT)),
        "height": h, "width": w,
        "bpp": nbytes * 8.0 / (h * w),
        "psnr": 10.0 * np.log10(1.0 / mse),
        "jpeg_bytes": sum(len(b) for b in comp["jpeg_buffers"]),
        "total_bytes": nbytes,
        "coder": args.coder,
        "host_fallbacks": jcodec.WIRE_STATS["host_fallbacks"],
        "frame_headers": sorted({hex(s[0]) for part in comp["strings"][0]
                                 for s in part} | {hex(s[0]) for s in comp["strings"][1]}),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
