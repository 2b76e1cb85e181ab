#!/usr/bin/env python3
"""Same-call A/B of the device coder's wire and the training step.

    python3 scripts/torch_wire_ab.py --baseline DIR [--turns 4]

Runs on one NVIDIA GPU, from the root of a checkout. ``DIR`` holds
another checkout's ``hyres_tpu_torch/`` (for example the parent commit's,
unpacked with ``git archive <commit> hyres_tpu_torch | tar -x -C DIR``
into a git-ignored directory). The script runs a worker process on each
package in alternating turns (baseline, this, this, baseline, ...), so
both share the card, its clocks and its power limit. Each worker imports
its own package, builds its kernels there, and measures, with this
checkout's artifact, on the smoke's 768x512 image and its two flips
(three requests, three times):

* ``HyresCodec(coder="device")`` in bf16 and f32: compress and
  decompress wall ms a request (sequential, after three warm-up
  requests; compress returns after its pull and framing, decompress
  waits on the event after its tail), the wall a request of
  ``inference_stream`` at depth 2, and the steady state's pulled and
  uploaded bytes and pulls a request (``WIRE_STATS``);
* the training step at the recipe (N=128, M=192, q=1, 16 seeded
  256x256 crops, the artifact's weights) in f32 and bf16: three warm-up
  steps, then the median of ten, wall ms with the card synchronised
  around each step.

Prints each turn's numbers and the medians over turns, and writes them
to ``smoke_out/torch_wire_ab.json`` together with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REQUESTS = 3          # passes over the three images
WARMUP = 3
TRAIN_WARMUP, TRAIN_TIMED = 3, 10


def _median(xs):
    return statistics.median(xs)


def worker(root: Path) -> dict:
    """The measurements of the package under ``root`` (run in its own
    process)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from hyres_tpu_torch.models import codec as tcodec
    from hyres_tpu_torch.models.hyres import HyresCodec, ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.utils.convert import load_state_dict
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact
    from hyres_tpu_torch.utils.png import load_image

    artifact = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
    img = load_image(ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png")
    x = torch.from_numpy(np.array(img)).cuda()
    xs = [x, x.flip(2).contiguous(), x.flip(1).contiguous()] * REQUESTS
    out = {"root": str(root), "serve": {}, "train": {}}

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, r

    for name, dt in (("bf16", torch.bfloat16), ("f32", None)):
        codec = HyresCodec.from_artifact(artifact, compute_dtype=dt, device="cuda",
                                         coder="device")
        for xi in xs[:WARMUP]:
            codec.decompress(codec.compress(xi))
        comp_ms, dec_ms, wire = [], [], []
        for xi in xs:
            tcodec.reset_wire_stats()
            ms_c, comp = wall(lambda: codec.compress(xi))
            pulled = (tcodec.WIRE_STATS["d2h_syncs"], tcodec.WIRE_STATS["d2h_bytes"])
            ms_d, _ = wall(lambda: codec.decompress(comp))
            comp_ms.append(ms_c)
            dec_ms.append(ms_d)
            wire.append([*pulled, tcodec.WIRE_STATS["h2d_bytes"],
                         tcodec.WIRE_STATS["host_fallbacks"]])
        ms_s, _ = wall(lambda: codec.inference_stream(xs, depth=2))
        out["serve"][name] = {"compress_ms": _median(comp_ms), "decompress_ms": _median(dec_ms),
                              "stream2_ms_a_request": ms_s / len(xs),
                              "compress_turns_ms": comp_ms, "decompress_turns_ms": dec_ms,
                              "wire_pulls_d2h_h2d_fallbacks": wire}
        del codec
        torch.cuda.empty_cache()

    _, params, _ = load_artifact(artifact)
    rng = np.random.default_rng(2026)
    base = np.array(img)[0]
    crops = []
    for _ in range(16):
        y0, x0 = (int(rng.integers(0, s - 256 + 1)) for s in base.shape[:2])
        crops.append(base[y0:y0 + 256, x0:x0 + 256])
    batch = torch.from_numpy(np.stack(crops).astype(np.float32)).cuda()
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        model = ResidualJPEGCompression(128, 192, 1, compute_dtype=dt)
        load_state_dict(model, params)
        model.cuda()
        main, aux = configure_optimizers(model, 1e-4, 1e-3, 1.0)
        step = make_train_step(create_train_state(model, main, aux), 0.015)
        gen = torch.Generator("cuda").manual_seed(0)
        for _ in range(TRAIN_WARMUP):
            step(batch, gen, True)
        times = [wall(lambda: step(batch, gen, True))[0] for _ in range(TRAIN_TIMED)]
        out["train"][name] = {"median_ms": _median(times), "step_ms": times}
        del model, main, aux, step
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", type=Path,
                   help="a directory holding another checkout's hyres_tpu_torch/")
    p.add_argument("--turns", type=int, default=4,
                   help="worker runs of each checkout, in the order b, t, t, b, ...")
    p.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.baseline is None:
        p.error("--baseline DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sides = {"baseline": args.baseline.resolve(), "this": ROOT}
    order = [("baseline", "this", "this", "baseline")[i % 4] for i in range(2 * args.turns)]
    runs = {"baseline": [], "this": []}
    for side in order:
        t = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                              str(sides[side])], cwd=sides[side], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(r)
        s, tr = r["serve"], r["train"]
        print(f"{side} ({time.perf_counter() - t:.1f} s): "
              + "; ".join(f"{k} compress {v['compress_ms']:.2f} decompress "
                          f"{v['decompress_ms']:.2f} stream2 {v['stream2_ms_a_request']:.2f} ms "
                          f"wire {v['wire_pulls_d2h_h2d_fallbacks'][-1]}" for k, v in s.items())
              + "; train " + ", ".join(f"{k} {v['median_ms']:.2f} ms" for k, v in tr.items()),
              flush=True)
    summary = {}
    for side, rs in runs.items():
        summary[side] = {
            "serve": {k: {m: _median([r["serve"][k][m] for r in rs])
                          for m in ("compress_ms", "decompress_ms", "stream2_ms_a_request")}
                      for k in rs[0]["serve"]},
            "train": {k: _median([r["train"][k]["median_ms"] for r in rs])
                      for k in rs[0]["train"]},
            "wire_steady": {k: rs[0]["serve"][k]["wire_pulls_d2h_h2d_fallbacks"][-1]
                            for k in rs[0]["serve"]}}
        print(f"{side} medians over {len(rs)} turns: {json.dumps(summary[side])}", flush=True)
    out = ROOT / "smoke_out" / "torch_wire_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smi, "order": order, "summary": summary,
                               "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
