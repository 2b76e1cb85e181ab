#!/usr/bin/env python3
"""Does a payload coded as a batch decode one image at a time, on the card?

    python3 scripts/torch_batch_decode.py [--batch 8]

Runs on one NVIDIA GPU, from the root of a checkout. ``HyresCodec`` from
the trained artifact at full width, in f32, on the host coder and then on
the device coder, compresses ``--batch`` 2x2 mosaics (1536x1024) of the
smoke's image and its flips (``chip_smoke._mosaics``) as one batch. Then,
for each image of that payload:

* decompresses it alone (batch 1) and counts the symbols that differ from
  the ones the batch coded, or the error the decode raised;
* runs the decoder's stages at batch 1 on the batch's own z and anchor
  symbols and counts the scale indexes that differ from the batch's: the
  decoder recomputes them, so one that differs codes a symbol against
  another table;
* compresses it alone as a whole request and says whether its residual
  and JFIF bytes equal the batch's.

The decoder's stages are the encoder's, so a payload always decodes at the
batch it was coded in; this measures the other case. Prints one line a
coder and writes everything, with the card's name and power limit, to
``smoke_out/torch_batch_decode.json``. Exits 0 whatever it finds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _image_of(comp: dict, i: int) -> dict:
    """Image i of a batch payload, as a payload of its own."""
    (a, n), z = comp["strings"]
    return {"strings": [[[a[i]], [n[i]]], [z[i]]], "shape": comp["shape"],
            "size": comp["size"], "jpeg_buffers": [comp["jpeg_buffers"][i]]}


def _np(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import ARTIFACT, IMAGE, _mosaics
    from hyres_tpu_torch.models.hyres import HyresCodec
    from hyres_tpu_torch.utils.png import load_image

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    xb = _mosaics(torch, torch.from_numpy(load_image(IMAGE)).cuda(), args.batch)
    res = {"card": card, "shape": list(xb.shape), "coders": {}}
    for coder in ("host", "device"):
        codec = HyresCodec.from_artifact(ARTIFACT, device="cuda", coder=coder)
        r = codec._residual
        comp = codec.compress(xb)
        with torch.inference_mode():
            z_sym, ((a_sym, a_idx), (_, n_idx)) = codec.latents(xb)
        images = []
        for i in range(args.batch):
            one = {}
            try:
                dec = codec.decompress(_image_of(comp, i))
                one["symbols_differing"] = sum(
                    int((_np(got)[0] != _np(coded)[i]).sum())
                    for got, coded in zip(dec["symbols"], comp["symbols"]))
            except Exception as e:  # a desynchronised stream may raise
                one["decode_error"] = f"{type(e).__name__}: {e}"
            with torch.inference_mode():
                lp1, a1_idx, ma1_p, _ = r.dec_stage1(z_sym[i:i + 1])
                n1_idx = r.dec_stage2(lp1, a_sym[i:i + 1], ma1_p)[1]
            one["indexes_differing"] = int((a1_idx[0] != a_idx[i]).sum()
                                           + (n1_idx[0] != n_idx[i]).sum())
            single = codec.compress(xb[i:i + 1])
            (a1, n1), z1 = single["strings"]
            (a, n), z = comp["strings"]
            one["request_bytes_equal"] = (a1[0], n1[0], z1[0]) == (a[i], n[i], z[i])
            one["jfif_bytes_equal"] = single["jpeg_buffers"][0] == comp["jpeg_buffers"][i]
            images.append(one)
        exact = sum(im.get("symbols_differing") == 0 for im in images)
        res["coders"][coder] = {
            "images": images, "decoded_exact_alone": exact,
            "symbols": sum(_np(s).size for s in comp["symbols"]),
            "indexes": a_idx.numel() + n_idx.numel(),
            "indexes_differing": sum(im["indexes_differing"] for im in images)}
        print(f"{coder} coder, f32, {args.batch} x {tuple(xb.shape[1:3])}: "
              f"{exact} of {args.batch} images decode exactly alone; scale indexes "
              f"differing at batch 1: {[im['indexes_differing'] for im in images]} of "
              f"{a_idx.numel() + n_idx.numel()}; whole requests' bytes equal the batch's: "
              f"{sum(im['request_bytes_equal'] for im in images)} of {args.batch}", flush=True)
        del codec, r, comp
        torch.cuda.empty_cache()
    print(card, flush=True)
    out = ROOT / "smoke_out" / "torch_batch_decode.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
