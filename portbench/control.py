#!/usr/bin/env python3
"""Readings that set the limits of ``correct`` (``limits/<cell>.json``):
the program's sound runs and the controls that must fail, several seeds in
one process. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds <n> ... [--seconds s]

Modes:

- ``program``: runs of the cell as the benchmark makes them (a window of
  ``--seconds``, then the comparison); the lower readings.
- ``program-bf16``: the same with the program's own bfloat16 path.
- ``tf32``: the reference computed with TF32 on, put in the program's place
  (the configuration states float32 with TF32 off: TF32 is the precision
  below it); serving cells judge as many requests as ``--requests``, and
  there the base layer's 8x8 DCT products, which get no TF32 kernel, run
  in bfloat16 (the reference re-encodes and decodes on the base layer the
  control sent, so the residual's numbers see TF32 alone); training cells
  judge the checked steps, with the same base layer.
- ``tf32-alone`` (training): the same with the base layer's DCT in
  float32, TF32 and nothing else.
- ``halfbatch`` (training): the reference in the program's place with its
  loss the mean over half of the batch.

Prints one JSON line a seed: {"mode", "workload", "seed", "numbers"}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def serve_control(cell, seed: int, requests: int, device) -> dict:
    """The reference in TF32 as the program: its symbols, its base layer
    and its reconstruction, judged by the float32 reference."""
    import torch

    from portbench.lib import check, spec, traffic as T
    from portbench.reference import common as C
    from portbench.reference import jpeg as J

    cfg, tr = cell.config, cell.traffic
    refmod = spec.reference_module(cfg)
    W = spec.config_module(cfg).reference_weights(cfg, spec.ROOT, device, refmod)
    ref = refmod.Reference(cfg, W)
    ctl = refmod.Reference(cfg, W)
    # the base layer's 8x8 DCT products get no TF32 kernel: the step below
    # float32 there is bfloat16
    ctl.dct_dtype = torch.bfloat16
    photos = T.Photos(tr, device)
    order = T.request_order(seed, T.requests(tr, photos))
    worst: dict = {}
    i = n = 0
    while n < requests:
        if T.sampled(seed, i, int(tr["sample_every"])):
            x = photos.window(order[i % len(order)])
            with torch.no_grad(), tf32(True):
                e = ctl.encode(x)
                jpeg = (e["coefs"], J.qtables(int(cfg["jpeg_quality"]))) if "coefs" in e else None
                x_hat = ctl.decode(e["symbols"], x.shape[1], x.shape[2], jpeg)
            with C.float32_numerics():
                nums = check.serve_numbers(ref, cfg, x, e["symbols"], e["symbols"], x_hat,
                                           jpeg, device)
            for k, v in nums.items():
                worst[k] = max(v, worst.get(k, 0.0))
            n += 1
        i += 1
    return worst


def train_control(cell, seed: int, mode: str, device) -> dict:
    """The reference as the program over the checked steps (TF32 on, with
    or without its base layer's DCT in bfloat16, or its loss over half of
    the batch), judged by the float32 reference."""
    import torch

    from portbench.lib import check, spec, traffic as T
    from portbench.lib.training import TrainFeed
    from portbench.reference import common as C

    cfg, tr = cell.config, cell.traffic
    cfgmod, refmod = spec.config_module(cfg), spec.reference_module(cfg)
    W = cfgmod.reference_weights(cfg, spec.ROOT, device, refmod)
    ref = refmod.Reference(cfg, W)
    ctl = refmod.Reference(cfg, W)
    if mode == "tf32":  # as in serving: the 8x8 DCT products get no TF32 kernel
        ctl.dct_dtype = torch.bfloat16
    feed = TrainFeed(cfgmod, cfg, tr, T.Photos(tr, device), seed, device)
    batches = [feed.batch(i) for i in range(int(tr["checked_steps"]))]
    lmbda = float(tr["lambda"])

    def loss(w, x, noise):
        if mode == "halfbatch":
            h = x.shape[0] // 2
            shapes = cfgmod.noise_shapes(cfg, (h,) + tuple(x.shape[1:]))
            noise = {k: v.reshape(-1)[:int(torch.tensor(s).prod())].reshape(s)
                     for (k, v), s in zip(noise.items(), shapes.values())}
            x = x[:h]
        return ctl.loss(w, x, noise, lmbda)

    Wt = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
    with C.float32_numerics(autotuned=True), tf32(mode.startswith("tf32")):
        out = C.train_steps(Wt, loss, [b[0] for b in batches], [b[1] for b in batches],
                            {"lr": tr["lr"], "aux_lr": tr["aux_lr"], "clip": tr["clip"]})
    grads = {n: torch.full((1,), g) for n, g in out["grad1"].items()}
    checked = {"before": W, "after": {k: v.detach() for k, v in out["W"].items()},
               "loss": out["loss"], "grad1": grads, "batches": batches}
    return check.train_numbers(ref, cfg, W, tr, checked, lambda n: n, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "program-bf16", "tf32", "tf32-alone", "halfbatch"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--sample-every", type=int, default=None,
                   help="check one request in this many (default: the traffic's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import harness, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    if args.sample_every:
        cell = dataclasses.replace(cell, traffic={**cell.traffic, "sample_every": args.sample_every})
    device = torch.device(args.device)
    for seed in args.seeds:
        if args.mode.startswith("program"):
            dt = torch.bfloat16 if args.mode == "program-bf16" else None
            r = harness.run(cell, seed, args.seconds, False, device_name=args.device,
                            compute_dtype=dt, log=lambda m: print(m, file=sys.stderr))
            nums = {k: v["value"] for k, v in r["checks"].items()}
        elif cell.traffic["loop"] == "train":
            nums = train_control(cell, seed, args.mode, device)
        else:
            nums = serve_control(cell, seed, args.requests, device)
        print(json.dumps({"mode": args.mode, "workload": args.workload, "seed": seed,
                          "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
