#!/usr/bin/env python3
"""Where a Cheng2020 request's device time goes, with g_a, h_a and g_s on
the coder path's deterministic cuDNN algorithms and on the autotuned
float32 ones that the program gives them.

    python3 scripts/torch_cheng_convs.py [--model attn-gmm3|anchor] [--shape H W] [--requests 3]

On a CUDA card, from the root of a checkout. Builds the benchmark's
``cheng2020-attn-gmm3-n192`` (``portbench/configs/``, its seeded weights)
or, with ``--model anchor``, Cheng2020-anchor at N = 192 on the port's
initialisers from seed 0 (scale bias 2.0), with the device coder, on a
``--shape`` window (height, width; the cell's 768 x 512 by default) of the
benchmark's photo mosaic, and for each policy (``--policy``: "deterministic", the transforms under the
process-wide deterministic flags, then "autotuned", the
program's ``autotuned_float32`` scope; or one of them alone, for a
process of its own) warms up two 768x512 roundtrips of the photo, then profiles
``--requests`` more: each call's wall (the compress to its bytes on the
host, the decompress to its reconstruction), its device-busy time, and its
largest kernels with their share of the busy time. Prints one JSON line a
policy and writes them all to
``smoke_out/torch_cheng_convs.<model>.<policy>.<H>x<W>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _kernels(prof, spans):
    """Per span name: (device seconds inside it by kernel, summed walls)."""
    dev, ranges = [], []
    for e in prof.events():
        kind = getattr(e.device_type, "name", str(e.device_type))
        if kind == "CUDA" and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith("convs."):
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif kind == "CPU" and e.name.startswith("convs."):
            ranges.append((e.time_range.start, e.time_range.end, e.name[6:]))
    out = {}
    for name in spans:
        by = defaultdict(float)
        wall = 0.0
        for s, e, n in ranges:
            if n != name:
                continue
            wall += (e - s) / 1e6
            for ks, ke, kn in dev:
                if ks >= s and ke <= e:
                    by[kn[:120]] += (ke - ks) / 1e6
        out[name] = (dict(by), wall)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="attn-gmm3", choices=("attn-gmm3", "anchor"))
    p.add_argument("--shape", type=int, nargs=2, default=(768, 512), metavar=("H", "W"))
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--policy", default="both", choices=("both", "deterministic", "autotuned"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hyres_tpu_torch.models import Cheng2020Codec, Cheng2020withCheckerboard, cheng_codec
    from hyres_tpu_torch.nn import init_parameters
    from portbench.lib import spec
    from portbench.lib.traffic import Photos

    device = torch.device("cuda")
    if args.model == "anchor":
        model = init_parameters(Cheng2020withCheckerboard(192), torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.entropy_parameters.Conv_2.Conv_0.bias[:192] = 2.0

        def build():
            codec = Cheng2020Codec(model, coder="device", device=device)
            codec.update()
            return codec

        def decompress(codec, comp):
            return codec.decompress(comp["strings"], comp["shape"], comp["size"])
    else:
        cfg = json.loads((ROOT / "portbench/configs/cheng2020-attn-gmm3-n192.json").read_text())
        cfg["name"] = "cheng2020-attn-gmm3-n192"
        cfgmod, refmod = spec.config_module(cfg), spec.reference_module(cfg)
        W = cfgmod.reference_weights(cfg, spec.ROOT, device, refmod)

        def build():
            return cfgmod.serving(cfg, spec.ROOT, device, W)

        decompress = cfgmod.decompress
    traffic = json.loads((ROOT / "portbench/traffic/serve-seq-gmm.json").read_text())
    x = Photos(traffic, device).window((*args.shape, 0, 0))
    autotuned = cheng_codec.autotuned_float32
    policies = {"deterministic": lambda device: contextlib.nullcontext(),
                "autotuned": autotuned}
    results = []
    for name, scope in policies.items():
        if args.policy not in ("both", name):
            continue
        cheng_codec.autotuned_float32 = scope
        codec = build()

        def roundtrip(times=None):
            t0 = time.perf_counter()
            with record_function("convs.compress"):
                comp = codec.compress(x)
            t1 = time.perf_counter()
            with record_function("convs.decompress"):
                decompress(codec, comp)
                torch.cuda.synchronize()
            if times is not None:
                times["compress"].append(t1 - t0)
                times["decompress"].append(time.perf_counter() - t1)

        for _ in range(2):
            roundtrip()
        torch.cuda.synchronize()
        times = defaultdict(list)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.requests):
                roundtrip(times)
        line = {"policy": name, "model": args.model, "shape": list(args.shape), "calls": {}}
        for call, (by, wall) in _kernels(prof, ("compress", "decompress")).items():
            busy = sum(by.values())
            top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
            line["calls"][call] = {
                "wall_ms": 1e3 * wall / args.requests,
                "host_clock_ms": [1e3 * t for t in times[call]],
                "busy_ms": 1e3 * busy / args.requests,
                "top": [[k, 1e3 * v / args.requests, 100.0 * v / busy] for k, v in top]}
        print(json.dumps(line), flush=True)
        results.append(line)
        del codec
        torch.cuda.empty_cache()
    cheng_codec.autotuned_float32 = autotuned
    out = ROOT / "smoke_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_cheng_convs.{args.model}.{args.policy}.{args.shape[0]}x{args.shape[1]}.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
