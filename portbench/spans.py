#!/usr/bin/env python3
"""One traced run of a cell, with the program's own spans read out.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout with a CUDA card. It makes the run that
``run.py --trace 1`` makes, unchanged, and also reads the profiled slice's
``hyres.*`` spans (``lib/program.py``): the device's idle time per call by
the group of the innermost program span (model launches, coder wire, host
work, the optimizer), pulls per compress, and how much of the idle time
inside the benchmark's own spans lies under a program span. It prints
``run.py``'s line with a ``program`` key added. A checkout whose program
opens no such span gives empty numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    cache = ROOT / ".portbench_cache"  # as run.py: inside the checkout, git-ignored
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from portbench.lib import harness, program, spec

    try:
        cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3

    read_profile = harness.read_profile
    found = {}

    def read_both(prof, wall):
        found["program"] = program.read(prof.events())
        return read_profile(prof, wall)

    harness.read_profile = read_both
    result = harness.run(cell, args.seed, args.seconds, True,
                         log=lambda m: print(f"portbench: {m}", file=sys.stderr, flush=True))
    loop = cell.traffic["loop"]
    prog = found.get("program", {})
    metrics = {name: fn(prog) for name, fn in program.METRICS.get(loop, {}).items()}
    result["program"] = {
        "metrics": {k: v for k, v in metrics.items() if v is not None},
        "coverage": program.coverage(prog, program.ENCLOSING.get(loop, ())),
        "roots": prog.get("roots", {}),
    }
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
