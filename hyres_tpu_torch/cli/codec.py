"""Codec CLI: encode images to .hyc files and decode them back to PNGs.

Counterpart of ``hyres_tpu/cli/codec.py``, with the same subcommands and
flags, except that ``--coder`` takes ``host`` or ``device`` (the JAX
package's ``tpu``), ``--device`` picks the card (``cuda``, the default)
or ``cpu`` (for tests), and ``--model`` runs ``hyres``, ``checkerboard``,
``elic``, ``cheng2020`` (``--cheng-variant attn-gmm3``: the attention and
Gaussian-mixture model, named ``cheng2020-attn-gmm3`` in the file) and
``tcm``.
``encode`` writes one self-describing HYC1 file per
input image (``coding/container.py``); ``decode`` needs only the .hyc and
the weights. A .hyc from either package decodes in the other.

    python -m hyres_tpu_torch.cli.codec encode \
        --checkpoint artifacts/hyres_n128_q1_l0032.msgpack \
        --coder device input.png -o out_dir/
    python -m hyres_tpu_torch.cli.codec decode \
        --checkpoint artifacts/hyres_n128_q1_l0032.msgpack \
        out_dir/input.hyc -o out_dir/

The bpp that ``encode`` prints counts the real file bytes, container
framing included.
"""

from __future__ import annotations

import argparse
import types
from pathlib import Path

import torch


def parse_args(argv=None):
    from .inference import MODELS, add_cheng_variant

    p = argparse.ArgumentParser(description="HyRES file codec on the PyTorch port")
    sub = p.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="PNG image(s) -> .hyc bitstream file(s)")
    enc.add_argument("inputs", nargs="+", help="PNG files or a directory")
    enc.add_argument("--checkpoint", type=str, required=True)
    enc.add_argument("-o", "--output", type=str, default=".",
                     help="output directory for .hyc files")
    enc.add_argument("--model", type=str, default="hyres", choices=MODELS)
    enc.add_argument("--N", type=int, default=128)
    enc.add_argument("--M", type=int, default=192)
    enc.add_argument("--jpeg-quality", type=int, default=1)
    add_cheng_variant(enc)
    enc.add_argument("--coder", type=str, default="host", choices=["host", "device"])
    enc.add_argument("--device", type=str, default="cuda",
                     help="'cuda' (default) or 'cpu' (for tests)")
    enc.add_argument("--no-refit-quantiles", dest="refit_quantiles",
                     action="store_false", default=True)

    dec = sub.add_parser("decode", help=".hyc file(s) -> reconstructed PNGs")
    dec.add_argument("inputs", nargs="+", help=".hyc files or a directory")
    dec.add_argument("--checkpoint", type=str, required=True,
                     help="weights for the model named in the container")
    dec.add_argument("-o", "--output", type=str, default=".",
                     help="output directory for reconstructed PNGs")
    dec.add_argument("--device", type=str, default="cuda",
                     help="'cuda' (default) or 'cpu' (for tests)")
    dec.add_argument("--no-refit-quantiles", dest="refit_quantiles",
                     action="store_false", default=True)
    return p.parse_args(argv)


def _expand(inputs, exts):
    files = []
    for item in inputs:
        p = Path(item)
        if p.is_dir():
            files += sorted(q for q in p.iterdir() if q.suffix.lower() in exts)
        else:
            files.append(p)
    return files


def _encode(args, device):
    from ..coding.container import pack_compressed
    from ..utils.png import load_image
    from .inference import load_codec

    _, codec, _ = load_codec(args, device)
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    files = _expand(args.inputs, {".png"})
    if not files:
        raise SystemExit("no input images")

    for f in files:
        x = torch.from_numpy(load_image(f)).to(device)
        comp = codec.compress(x)
        model = (args.model if args.model != "cheng2020" or args.cheng_variant == "anchor"
                 else f"cheng2020-{args.cheng_variant}")
        blob = pack_compressed(comp, model=model, N=args.N, M=args.M,
                               jpeg_quality=(args.jpeg_quality
                                             if args.model == "hyres" else None),
                               coder=args.coder)
        out = outdir / (f.stem + ".hyc")
        out.write_bytes(blob)
        bpp = len(blob) * 8 / (x.shape[1] * x.shape[2])
        print(f"{f.name} -> {out} ({len(blob)} B, {bpp:.4f} bpp "
              f"incl. container framing)", flush=True)


def _decode(args, device):
    from ..coding.container import coder_for_container, unpack_compressed
    from ..utils.png import save_image
    from .inference import load_codec

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    files = _expand(args.inputs, {".hyc"})
    if not files:
        raise SystemExit("no input .hyc files")

    codecs = {}  # one codec per (model, N, M, q, coder) among the files
    for f in files:
        doc = unpack_compressed(f.read_bytes())
        key = (doc["model"], doc["N"], doc["M"], doc["jpeg_quality"], doc["coder"])
        if key not in codecs:
            model, _, variant = doc["model"].partition("-")
            args_like = types.SimpleNamespace(
                checkpoint=args.checkpoint, refit_quantiles=args.refit_quantiles,
                model=model, cheng_variant=variant or "anchor", N=doc["N"], M=doc["M"],
                jpeg_quality=doc["jpeg_quality"] or 1,
                coder=coder_for_container(doc["coder"]))
            codecs[key] = load_codec(args_like, device)[1]
        codec = codecs[key]
        payload = doc["payload"]
        dec = (codec.decompress(payload) if "jpeg_buffers" in payload
               else codec.decompress(payload["strings"], payload["shape"],
                                     payload.get("size")))
        out = outdir / (f.stem + ".png")
        save_image(torch.clamp(dec["x_hat"], 0, 1), out)
        print(f"{f.name} ({doc['model']} N={doc['N']} M={doc['M']} "
              f"coder={doc['coder']}) -> {out}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.cmd == "encode":
        _encode(args, device)
    else:
        _decode(args, device)


if __name__ == "__main__":
    main()
