#!/usr/bin/env python3
"""K7 (``kernels/window_attn.py``) at TCM's published attention shapes:
device time against the bound and against the plain version.

    python3 scripts/torch_window_attn_time.py [--calls 50] [--split 3]

On a CUDA card, from the root of a checkout. For each shape (768x512
image: g_a's stages, SWAtten on y, h_a / h_s) and W / SW, it times
``--calls`` back-to-back launches between two CUDA events (after a warm-up
launch) and the plain version (``window_attention_ref`` on the card's
tensors, TF32 off) the same way, and gives the bound of a call: the larger
of its least bytes (qkv read once, the output written once, the bias table
once) at 3.35 TB/s and of QK^T and PV at 67 TFLOP/s. With ``--split n``
it then builds the benchmark's ``tcm-n128-m320`` codec (its seeded
weights), warms up two roundtrips of a 768x512 window of the photo and
profiles n more, summing each call's device time by kind of kernel
(convolutions, dense layers, K7, the coder, LayerNorm, the rest). Prints
one JSON line a shape (and one a call kind) and writes them all to
``smoke_out/torch_window_attn_time.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hyres_tpu_torch.kernels import window_attn as k7  # noqa: E402

# (H, W, C, head width, window) of a 768x512 request
SHAPES = [(384, 256, 128, 8, 8), (192, 128, 128, 16, 8), (96, 64, 128, 32, 8),
          (48, 32, 128, 16, 8), (24, 16, 128, 32, 4)]


def _time(fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


KINDS = [("K7", r"window_attn_kernel"),
         ("coder", r"encode_kernel|decode_warp_kernel|rans|pack|unpack"),
         ("convolutions", r"fprop|conv|fft|cudnn|implicit_gemm|region_transform|winograd"),
         ("dense", r"gemm|cublas"),
         ("layer_norm", r"layer_norm")]


def split(n: int) -> list:
    """Device ms a call by kind of kernel, over n profiled roundtrips."""
    import re

    from portbench.lib import spec
    from portbench.lib import traffic as T

    cfg = {**json.loads((ROOT / "portbench/configs/tcm-n128-m320.json").read_text()),
           "name": "tcm-n128-m320"}
    cfgmod, refmod = spec.config_module(cfg), spec.reference_module(cfg)
    device = torch.device("cuda")
    W = cfgmod.reference_weights(cfg, ROOT, device, refmod)
    codec = cfgmod.serving(cfg, ROOT, device, W)
    tr = json.loads((ROOT / "portbench/traffic/serve-seq.json").read_text())
    x = T.Photos(tr, device).window((768, 512, 0, 0))  # the cell's first window
    for _ in range(2):
        cfgmod.decompress(codec, codec.compress(x))
    torch.cuda.synchronize()
    rows = []
    for call in ("compress", "decompress"):
        comp = codec.compress(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if call == "compress":
                    codec.compress(x)
                else:
                    cfgmod.decompress(codec, comp)
            torch.cuda.synchronize()
        ms = {k: 0.0 for k, _ in KINDS}
        ms["other"] = 0.0
        for e in prof.key_averages():
            t = e.device_time_total / 1e3 / n
            if t <= 0:
                continue
            kind = next((k for k, pat in KINDS if re.search(pat, e.key, re.I)), "other")
            ms[kind] += t
        rows.append({"call": call, "device_ms": sum(ms.values()), "by_kind_ms": ms})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=50)
    p.add_argument("--split", type=int, default=0, metavar="N",
                   help="also profile N TCM roundtrips by kind of kernel")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for H, W, C, d, p_ in SHAPES:
        qkv = torch.randn((1, H, W, 3 * C), device="cuda", generator=g)
        bias = k7.relative_bias(torch.randn((C // d, 2 * p_ - 1, 2 * p_ - 1), device="cuda",
                                            generator=g), p_)
        tokens = H * W
        nbytes = 4 * (4 * tokens * C + (C // d) * p_ ** 4)
        flops = 4 * tokens * p_ * p_ * C
        for shifted in (False, True):
            ms = _time(lambda: k7.window_attention(qkv, bias, C // d, p_, shifted), args.calls)
            plain = _time(lambda: k7.window_attention_ref(qkv, bias, C // d, p_, shifted),
                          max(args.calls // 10, 3))
            row = {"card": card, "H": H, "W": W, "C": C, "d": d, "p": p_, "shifted": shifted,
                   "device_ms": ms, "plain_ms": plain,
                   "bytes_ms": 1e3 * nbytes / 3.35e12, "flops_ms": 1e3 * flops / 67e12}
            row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
            row["share_of_bound"] = 100.0 * row["bound_ms"] / ms
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.split:
        rows += split(args.split)
    out = ROOT / "smoke_out" / "torch_window_attn_time.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
