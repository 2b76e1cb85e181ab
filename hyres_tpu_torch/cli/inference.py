"""Inference CLI: compress/decompress roundtrips with rate and quality.

Counterpart of ``hyres_tpu/cli/inference.py``, with the same flags, except
that ``--coder`` takes ``host`` or ``device`` (the JAX package's ``tpu``),
``--device`` picks the card (``cuda``, the default) or ``cpu`` (for
tests). ``--model`` runs ``hyres``, ``checkerboard``, ``elic``,
``cheng2020`` and ``tcm``. bpp counts the real string and buffer bytes (y, z, JPEG,
over each family's strings nest); PSNR and
MS-SSIM come from ``losses/metrics.py``; ``metrics.csv`` has the
reference's columns plus ``average`` and ``median`` rows, and
``fallbacks.txt`` the device coder's host fallbacks. Inputs are PNG files
(the port reads images with its own PNG reader).

    python -m hyres_tpu_torch.cli.inference \
        --checkpoint artifacts/hyres_n128_q1_l0032.msgpack \
        --coder device --input images/ --output out/ --stream 2
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import time
from pathlib import Path

import numpy as np
import torch

# cheng2020's variants: the reference's anchor model, or the paper's
# attention transforms and 3-component Gaussian mixture (arXiv:2001.01568,
# the device coder only); a .hyc names a variant as "cheng2020-<variant>"
CHENG_VARIANTS = {"anchor": {}, "attn-gmm3": {"attention": True, "mixtures": 3}}


MODELS = ["hyres", "checkerboard", "elic", "cheng2020", "tcm"]


def add_cheng_variant(p) -> None:
    p.add_argument("--cheng-variant", type=str, default="anchor", choices=sorted(CHENG_VARIANTS),
                   help="cheng2020 only: 'anchor' (the reference's model) or 'attn-gmm3' "
                        "(attention and a 3-component Gaussian mixture; --coder device)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HyRES inference on the PyTorch port")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--input", type=str, required=True, help="PNG image or directory")
    p.add_argument("--output", type=str, default="./inference_out")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=192)
    p.add_argument("--jpeg-quality", type=int, default=1)
    p.add_argument("--model", type=str, default="hyres", choices=MODELS)
    add_cheng_variant(p)
    p.add_argument("--save-components", action="store_true")
    p.add_argument("--coder", type=str, default="host", choices=["host", "device"],
                   help="entropy coder: 'host' (C++ rANS, rate-optimal framing) "
                        "or 'device' (lane-parallel rANS on the card, one pull "
                        "and one upload a request at ~4 B/lane of stream)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (for tests)")
    p.add_argument("--cuda", action="store_true", help="ignored (see --device)")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the timed "
                        "roundtrips here (a .json file, or a directory that "
                        "gets trace.json); the trace carries the port's "
                        "hyres.* spans (utils/trace.py) beside the kernels")
    p.add_argument("--no-refit-quantiles", dest="refit_quantiles",
                   action="store_false", default=True,
                   help="skip the closed-form quantile refit applied when "
                        "loading a raw training checkpoint")
    p.add_argument("--batch", type=int, default=1,
                   help="compress/decompress N same-shape images per call; "
                        "rate/quality columns stay per image (frames are per "
                        "image under both coders), enc/dec_time become "
                        "per-image amortized wall times")
    p.add_argument("--stream", type=int, default=0, metavar="DEPTH",
                   help="pipelined serving: keep DEPTH items in flight so "
                        "item i's pull and host framing overlap item i+1's "
                        "device work (inference_stream); outputs equal "
                        "sequential mode bit for bit; composes with --batch")
    p.add_argument("--cold-timings", action="store_true",
                   help="skip the warm-up roundtrip per shape before the timed "
                        "loop")
    return p.parse_args(argv)


def build_codec(args, params, device):
    """(model, codec) for ``args.model`` with ``params`` = {"params": tree}.
    ELIC and Cheng2020 take their own defaults where the flags keep theirs
    (N 128 -> 192, M 192 -> 320), as the reference's CLI does; TCM keeps N
    and takes M 192 -> 320."""
    from .. import models
    from ..utils.convert import load_state_dict

    coder = getattr(args, "coder", "host")
    if args.model == "hyres":
        model = models.ResidualJPEGCompression(N=args.N, M=args.M,
                                               jpeg_quality=args.jpeg_quality)
        codec_cls = models.HyresCodec
    elif args.model == "checkerboard":
        model = models.LightWeightCheckerboard(N=args.N, M=args.M)
        codec_cls = models.CheckerboardCodec
    elif args.model == "elic":
        model = models.LightWeightELIC(N=args.N if args.N != 128 else 192,
                                       M=args.M if args.M != 192 else 320)
        codec_cls = models.ElicCodec
    elif args.model == "tcm":
        model = models.TCM(N=args.N, M=args.M if args.M != 192 else 320)
        codec_cls = models.TcmCodec
    else:
        model = models.Cheng2020withCheckerboard(
            N=args.N if args.N != 128 else 192,
            **CHENG_VARIANTS[getattr(args, "cheng_variant", "anchor")])
        codec_cls = models.Cheng2020Codec
    load_state_dict(model, params["params"])
    return model, codec_cls(model, coder=coder, device=device)


def load_codec(args, device):
    """Checkpoint -> (model, codec) with tables: an artifact's baked tables
    are installed; a raw training checkpoint has its quantiles refit
    (unless --no-refit-quantiles) and its tables baked."""
    from ..entropy import refit_model_quantiles
    from ..train import extract_variables, load_checkpoint

    raw = load_checkpoint(args.checkpoint)
    params = extract_variables(raw)
    baked = isinstance(raw, dict) and "tables" in raw
    if getattr(args, "refit_quantiles", True) and not baked:
        params = refit_model_quantiles(params)
    model, codec = build_codec(args, params, device)
    if baked:
        codec.install_tables(raw["tables"])
    else:
        codec.update(force=True)
    return model, codec, baked


def _nbytes(obj) -> int:
    """Total byte length of an arbitrarily nested list of buffers."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    return sum(_nbytes(s) for s in obj)


def strings_nbytes(comp) -> dict:
    return {
        "y": _nbytes(comp["strings"][0]),
        "z": _nbytes(comp["strings"][1]),
        "jpeg": _nbytes(comp.get("jpeg_buffers", [])),
    }


def _nbytes_image(obj, i: int) -> int:
    """Bytes of image ``i`` in a batched compress()'s strings nest: the
    innermost list of buffers is per image under both coders."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if obj and all(isinstance(s, (bytes, bytearray, memoryview)) for s in obj):
        return len(obj[i])
    return sum(_nbytes_image(s, i) for s in obj)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decompress(codec, comp):
    if "jpeg_buffers" in comp:
        return codec.decompress(comp)
    return codec.decompress(comp["strings"], comp["shape"], comp.get("size"))


def _load(paths, device) -> torch.Tensor:
    from ..utils.png import load_image

    return torch.from_numpy(np.concatenate([load_image(p) for p in paths])).to(device)


def _row(path, comp, i, x, x_hat, enc_time, dec_time) -> dict:
    """One metrics.csv row for image ``i`` of a (batched) roundtrip."""
    from ..losses import ms_ssim

    H, W = x.shape[1], x.shape[2]
    nb = {
        "y": _nbytes_image(comp["strings"][0], i),
        "z": _nbytes_image(comp["strings"][1], i),
        "jpeg": len(comp["jpeg_buffers"][i]) if "jpeg_buffers" in comp else 0,
    }
    bpp = {k: v * 8 / (H * W) for k, v in nb.items()}
    mse = float(torch.mean((x[i] - x_hat[i]) ** 2))
    return {
        "filename": Path(path).name,
        "total_bpp": sum(bpp.values()),
        "jpeg_bpp": bpp["jpeg"],
        "y_bpp": bpp["y"],
        "z_bpp": bpp["z"],
        "mse": mse,
        "psnr": -10 * np.log10(mse),
        "ms_ssim": float(ms_ssim(x[i: i + 1], x_hat[i: i + 1])),
        "enc_time": enc_time,
        "dec_time": dec_time,
    }


def _timed_roundtrip(codec, x):
    dev = codec.device
    _sync(dev)
    t0 = time.perf_counter()
    comp = codec.compress(x)
    _sync(dev)
    enc_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = _decompress(codec, comp)
    _sync(dev)
    dec_time = time.perf_counter() - t0
    return comp, torch.clamp(dec["x_hat"], 0, 1), enc_time, dec_time


def process_batch(codec, paths, outdir: Path):
    """One compress + one decompress for N same-shape images; per-image
    rate and quality, amortized per-image wall times."""
    from ..utils.png import save_image

    x = _load(paths, codec.device)
    comp, x_hat, enc_time, dec_time = _timed_roundtrip(codec, x)
    B = x.shape[0]
    rows = []
    for i, path in enumerate(paths):
        save_image(x_hat[i], outdir / f"{Path(path).stem}_recon.png")
        rows.append(_row(path, comp, i, x, x_hat, enc_time / B, dec_time / B))
    return rows


def process_image(codec, path: str, outdir: Path, save_components: bool):
    from ..utils.png import save_image

    x = _load([path], codec.device)
    comp, x_hat, enc_time, dec_time = _timed_roundtrip(codec, x)
    row = _row(path, comp, 0, x, x_hat, enc_time, dec_time)
    name = Path(path).stem
    save_image(x_hat, outdir / f"{name}_recon.png")
    if save_components and "jpeg_buffers" in comp:
        jpeg_dec = codec.decode_jpeg(comp["jpeg_buffers"])
        save_image(jpeg_dec, outdir / f"{name}_jpeg.png")
        save_image((x - jpeg_dec) * 0.5 + 0.5, outdir / f"{name}_residual.png")
    return row


def _write_csv(outdir: Path, rows):
    """metrics.csv with the reference's columns, an ``average`` row (for
    enc_time/dec_time without rows above 2x the column median, each
    exclusion reported) and a ``median`` row; fallbacks.txt from
    ``WIRE_STATS``."""
    from ..models import codec as codec_mod

    keys = list(rows[0])
    med = {k: float(np.median([r[k] for r in rows])) for k in keys if k != "filename"}
    avg = {}
    for k in keys:
        if k == "filename":
            continue
        vals = [r[k] for r in rows]
        if k in ("enc_time", "dec_time"):
            kept = [v for v in vals if v <= 2 * med[k]] or vals
            if len(kept) < len(vals):
                out = [(r["filename"], r[k]) for r in rows if r[k] > 2 * med[k]]
                print(f"WARNING: {k} average excludes {len(vals) - len(kept)} "
                      f"outlier row(s) > 2x median ({med[k]:.3f}s): {out}; the "
                      "median row is unaffected")
            avg[k] = float(np.mean(kept))
        else:
            avg[k] = float(np.mean(vals))
    print(f"AVG: bpp={avg['total_bpp']:.4f} psnr={avg['psnr']:.2f} "
          f"ms-ssim={avg['ms_ssim']:.4f} enc={avg['enc_time']:.3f}s "
          f"dec={avg['dec_time']:.3f}s")
    fb = codec_mod.WIRE_STATS["host_fallbacks"]
    if fb:
        print(f"WARNING: {fb} compress() call(s) fell back to the host coder "
              "(stream-cap/escape overflow); enc_time rows for those images "
              f"measure the host coder: {codec_mod.WIRE_STATS['fallback_reasons'][-3:]}")
    with open(outdir / "fallbacks.txt", "w") as f:
        f.write(f"host_fallbacks={fb}\n")
        for r in codec_mod.WIRE_STATS["fallback_reasons"]:
            f.write(r + "\n")
    with open(outdir / "metrics.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
        w.writerow({"filename": "average", **avg})
        w.writerow({"filename": "median", **med})


def _profiler(path, device):
    """A torch.profiler context that writes a Chrome trace to ``path``."""
    if not path:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    out = Path(path)
    if out.suffix != ".json":
        out.mkdir(parents=True, exist_ok=True)
        out = out / "trace.json"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    @contextlib.contextmanager
    def run():
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(str(out))
        print(f"profiler trace -> {out}")

    return run()


def _warm(codec, xs) -> None:
    """One roundtrip a distinct input shape, synchronised, before timing."""
    seen = set()
    for x in xs:
        if tuple(x.shape) in seen:
            continue
        seen.add(tuple(x.shape))
        _decompress(codec, codec.compress(x))
        _sync(codec.device)


def _group(files, n: int):
    """Same-shape files in chunks of at most ``n`` (input order within a
    shape, shapes in order of first appearance)."""
    from ..utils.png import read_png

    groups: dict = {}
    for f in files:
        groups.setdefault(read_png(f).shape, []).append(f)
    return [fs[i: i + n] for fs in groups.values() for i in range(0, len(fs), n)]


def _run_batched(args, codec, files, outdir: Path):
    """--batch N: same-shape files grouped, N roundtripped per call."""
    if args.save_components:
        print("--save-components is ignored in --batch mode")
    batches = _group(files, args.batch)
    if not args.cold_timings:
        _warm(codec, [_load(b, codec.device) for b in batches])
    rows = []
    with _profiler(args.profile, codec.device):
        for b in batches:
            rs = process_batch(codec, b, outdir)
            rows.extend(rs)
            for r in rs:
                print(f"{r['filename']}: bpp={r['total_bpp']:.4f} "
                      f"psnr={r['psnr']:.2f} ms-ssim={r['ms_ssim']:.4f} "
                      f"enc={r['enc_time']:.3f}s dec={r['dec_time']:.3f}s "
                      f"(batch of {len(b)}, per-image)", flush=True)
    _write_csv(outdir, rows)


def _run_streamed(args, codec, files, outdir: Path):
    """--stream DEPTH: pipelined roundtrips (``inference_stream``), of
    --batch N same-shape batches when N > 1. Rate and quality columns are
    exact; enc/dec_time are the stream's wall time split per image by each
    item's compress/decompress span share."""
    from ..utils.png import save_image

    if args.save_components:
        print("--save-components is ignored in --stream mode")
    nb_batch = max(1, args.batch)
    chunks = _group(files, nb_batch) if nb_batch > 1 else [[f] for f in files]
    xs = [_load(c, codec.device) for c in chunks]
    if not args.cold_timings:
        _warm(codec, xs)

    with _profiler(args.profile, codec.device):
        _sync(codec.device)
        t0 = time.perf_counter()
        outs = codec.inference_stream(xs, depth=args.stream)
        _sync(codec.device)
        wall = time.perf_counter() - t0

    spans = [(o["time"]["compression"], o["time"]["decompression"]) for o in outs]
    tot = sum(e + d for e, d in spans) or 1.0
    rows = []
    for paths, x, o, (e, d) in zip(chunks, xs, outs, spans):
        B = x.shape[0]
        x_hat = torch.clamp(o["x_hat"], 0, 1)
        share = wall * (e + d) / tot / B
        for i, path in enumerate(paths):
            save_image(x_hat[i], outdir / f"{Path(path).stem}_recon.png")
            rows.append(_row(path, o["compressed"], i, x, x_hat,
                             share * e / (e + d), share * d / (e + d)))
            r = rows[-1]
            print(f"{r['filename']}: bpp={r['total_bpp']:.4f} "
                  f"psnr={r['psnr']:.2f} ms-ssim={r['ms_ssim']:.4f} "
                  f"enc={r['enc_time']:.3f}s dec={r['dec_time']:.3f}s "
                  f"(streamed{f', batch of {B}' if B > 1 else ''}, "
                  f"per-image amortized)", flush=True)
    n_img = sum(len(c) for c in chunks)
    print(f"stream total: {wall:.3f}s for {n_img} images = {wall / n_img:.4f} "
          f"s/image (depth {args.stream}"
          f"{f', batch {nb_batch}' if nb_batch > 1 else ''})")
    _write_csv(outdir, rows)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    _, codec, baked = load_codec(args, device)
    if baked:
        print("using pre-baked CDF tables from the updata artifact")

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    inp = Path(args.input)
    files = ([str(inp)] if inp.is_file() else sorted(
        str(p) for p in inp.iterdir() if p.suffix.lower() == ".png"))
    if not files:
        raise SystemExit(f"no PNG images found at {args.input}")

    if args.stream > 0:
        _run_streamed(args, codec, files, outdir)  # honours --batch too
        return
    if args.batch > 1:
        _run_batched(args, codec, files, outdir)
        return

    if not args.cold_timings:
        _warm(codec, [_load([f], device) for f in files])
    rows = []
    with _profiler(args.profile, device):
        for f in files:
            r = process_image(codec, f, outdir, args.save_components)
            rows.append(r)
            print(f"{r['filename']}: bpp={r['total_bpp']:.4f} "
                  f"(jpeg {r['jpeg_bpp']:.4f} y {r['y_bpp']:.4f} z {r['z_bpp']:.4f}) "
                  f"psnr={r['psnr']:.2f} ms-ssim={r['ms_ssim']:.4f} "
                  f"enc={r['enc_time']:.3f}s dec={r['dec_time']:.3f}s", flush=True)
    _write_csv(outdir, rows)


if __name__ == "__main__":
    main()
