#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch port (``hyres_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with CUDA cards. It sets up the cell (the
program, its weights, the traffic from ``--seed``), warms up every shape
the traffic uses, measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number that
decided ``correct`` beside its limit, which also close standard error.
Without a CUDA card, or with fewer than the cell asks for, it exits 3 and
prints no result; with JAX or the JAX package loaded once the window has
closed, it exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"  # fixed, inside the checkout, git-ignored


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from portbench.lib import spec

    try:
        cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3

    from portbench.lib import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         log=lambda m: print(f"portbench: {m}", file=sys.stderr, flush=True))
    found = harness.loaded_jax()
    if found:
        print(f"portbench: JAX modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
