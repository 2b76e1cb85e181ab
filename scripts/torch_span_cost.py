#!/usr/bin/env python3
"""What the port's spans (``hyres_tpu_torch/utils/trace.py``) cost.

    python scripts/torch_span_cost.py [--calls 200000]

Times ``with span(...): pass`` with no profiler running (the one flag
test), ``torch.profiler.record_function`` alone with no profiler (what an
unguarded span would cost), and ``span`` under a running
``torch.profiler`` session, in microseconds a call on the host's clock
(best of three rounds). On a CUDA card it also profiles one span around a
kernel and reports the device-side range the profiler draws for it: its
device type and whether it is flagged as a user annotation, which the
benchmark's readers leave out of device time. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from hyres_tpu_torch.utils.trace import span  # noqa: E402


def _us(fn, calls: int) -> float:
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        fn(calls)
        best = min(best, time.perf_counter() - t)
    return 1e6 * best / calls


def _spans(n):
    for _ in range(n):
        with span("model.params"):
            pass


def _ranges(n):
    for _ in range(n):
        with torch.profiler.record_function("hyres.model.params"):
            pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=200_000)
    args = p.parse_args(argv)
    out = {"torch": torch.__version__,
           "span_off_us": _us(_spans, args.calls),
           "record_function_off_us": _us(_ranges, args.calls),
           "flag_test_us": _us(lambda n: [torch.autograd._profiler_enabled()
                                          for _ in range(n)], args.calls)}
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts):
        out["span_on_us"] = _us(_spans, args.calls // 10)
    if cuda:
        out["card"] = torch.cuda.get_device_name(0)
        x = torch.ones(1 << 20, device="cuda")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with span("model.params"):
                x.mul_(2)
            torch.cuda.synchronize()
        out["device_side_ranges"] = [
            {"name": e.name, "device_type": str(e.device_type),
             "is_user_annotation": bool(getattr(e, "is_user_annotation", False))}
            for e in prof.events() if e.name.startswith("hyres.")]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
