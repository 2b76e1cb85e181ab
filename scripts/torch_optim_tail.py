#!/usr/bin/env python3
"""Kernels the training step's optimizer tail launches, by span.

    python scripts/torch_optim_tail.py [--root CHECKOUT]

On a CUDA card: the recipe's step (the artifact's weights, 16 crops of
256x256, noise quantisation, clip 1) of the port in ``CHECKOUT`` (default:
this one; an unpacked older commit for a comparison), two warm-up steps,
then one profiled step. Every kernel is given to the host op that launched
it and that op to the innermost ``hyres.optim.*`` span around it. The aux
loss's own forward (wrapped here in a range) is counted apart; its
backward runs on autograd's device thread, outside the spans. Prints one
JSON object with the counts, each span's host milliseconds and, where the
checkout has it, ``OPTIM_STATS``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_optim_tail: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(args.root.resolve()))
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.train import optimizers
    from hyres_tpu_torch.utils.convert import load_state_dict
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    root = Path(__file__).resolve().parent.parent
    _, params, _ = load_artifact(root / "artifacts" / "hyres_n128_q1_l0032.msgpack")
    model = ResidualJPEGCompression(128, 192, 1)
    load_state_dict(model, params)
    model.cuda()
    step = make_train_step(create_train_state(model, *configure_optimizers(model, 1e-4, 1e-3, 1.0)),
                           0.0032)
    x = torch.rand(16, 256, 256, 3, generator=torch.Generator().manual_seed(0)).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(2):
        step(x, gen, True)
    torch.cuda.synchronize()
    aux_loss = model.aux_loss

    def ranged_aux_loss():
        with torch.profiler.record_function("aux_loss"):
            return aux_loss()

    model.aux_loss = ranged_aux_loss
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(x, gen, True)
        torch.cuda.synchronize()
    kernels, host_ms = Counter(), {}
    for e in prof.events():
        if e.name.startswith("hyres.optim.") and e.device_type.name == "CPU":
            host_ms[e.name] = (e.time_range.end - e.time_range.start) / 1e3
        if not e.kernels or e.name.startswith("cu"):  # the runtime's own events
            continue
        o = e
        while o is not None and not o.name.startswith(("hyres.optim.", "aux_loss")):
            o = o.cpu_parent
        if o is not None:
            kernels[o.name] += len(e.kernels)
    aux = kernels.pop("aux_loss", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "kernels": dict(kernels),
                      "tail_kernels": sum(kernels.values()), "aux_loss_forward_kernels": aux,
                      "host_ms": host_ms,
                      "optim_stats": getattr(optimizers, "OPTIM_STATS", None)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
