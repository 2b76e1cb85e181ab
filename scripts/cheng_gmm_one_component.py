#!/usr/bin/env python3
"""The control of ``gmm_rate_gap``: the ``cheng2020.serve-seq`` cell with
the program's mixture rows built from each element's largest-weight
component alone.

    python3 scripts/cheng_gmm_one_component.py --seeds <n> ... [--seconds 5]

On a CUDA card, from the root of a checkout. Each seed is one run of the
cell as ``portbench/run.py`` makes it (untraced), with the codec's row
builder wrapped: the other components' logits go to the largest one's
less 8. Encoder and decoder build the same rows, so the
decode stays exact and only the rate moves. Prints one JSON line a seed:
{"mode": "one-component", "seed", "numbers"}, the numbers that decide
``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "cheng2020.serve-seq"


def one_component(codec):
    """Wrap the codec's row builder: each element's components but its
    largest-weight one drop to e^-8 of its weight."""
    import torch

    dc = codec.device_coder
    build = dc.gmm_rows

    def rows(params, K):
        M = params.shape[-1] // (3 * K)
        logits = params[..., :K * M].unflatten(-1, (K, M))
        top = logits.argmax(-2, keepdim=True)
        ks = torch.arange(K, device=params.device).view(*([1] * (logits.dim() - 2)), K, 1)
        keep = torch.where(ks == top, torch.zeros_like(logits), torch.full_like(logits, -8.0))
        return build(torch.cat([keep.flatten(-2), params[..., K * M:]], -1), K)

    dc.gmm_rows = rows
    return codec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.lib import harness, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), CELL, ROOT)
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, device_name=args.device,
                        fault=one_component, log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"mode": "one-component", "workload": CELL, "seed": seed,
                          "numbers": {k: v["value"] for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
