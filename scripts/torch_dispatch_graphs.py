#!/usr/bin/env python3
"""A run of a serving cell with the dispatch graphs' counters read around
its window.

    python3 scripts/torch_dispatch_graphs.py --workload hyres.serve-seq --seed <n> \\
        --seconds <s> [--trace 1]

from the root of a checkout with a CUDA card. It makes ``portbench/run.py``'s
run (with ``--trace 1``, ``portbench/spans.py``'s, which adds the idle time
by program span) and prints its line, then one more JSON line: the window's
compresses and, from ``WIRE_STATS``, how many of them replayed a CUDA graph
of their dispatch half, captured one or ran op by op (``models/graphs.py``),
and the same over the whole process (warm-up, window and the profiled
slice). A checkout without the counters gives nulls.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("graph_replays", "graph_captures", "eager_dispatches", "host_fallbacks", "d2h_syncs")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from hyres_tpu_torch.models import codec as tcodec
    from portbench import run, spans
    from portbench.lib import spec

    def read():
        return {k: tcodec.WIRE_STATS.get(k) for k in KEYS}

    window = {}
    loop_module = spec.loop_module

    def counted(name):
        mod = loop_module(name)
        timed = mod.Loop.window
        if getattr(timed, "counted", False):
            return mod

        def window_counted(self, seconds):
            before = read()
            rec = timed(self, seconds)
            after = read()
            window.update(compresses=rec["images"], **{
                k: None if after[k] is None else after[k] - before[k] for k in KEYS})
            return rec
        window_counted.counted = True
        mod.Loop.window = window_counted
        return mod

    spec.loop_module = counted
    tcodec.reset_wire_stats()
    common = ["--workload", args.workload, "--seed", str(args.seed),
              "--seconds", str(args.seconds)]
    rc = spans.main(common) if args.trace else run.main(common + ["--trace", "0"])
    print(json.dumps({"window": window, "process": read()}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
