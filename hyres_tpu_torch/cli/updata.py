"""CDF-export CLI ("updata"): bake entropy-coder tables for deployment.

Counterpart of ``hyres_tpu/cli/updata.py``, with the same flags: load a
training checkpoint, refit the bottleneck quantiles from the density
(unless --no-refit-quantiles), bake the gaussian and bottleneck CDF
tables, and save ``params``, ``tables`` and ``config`` (--N, --M,
--jpeg-quality) as one flax msgpack artifact. JAX's ``load_checkpoint``
and the port's ``load_artifact`` both read it.

    python -m hyres_tpu_torch.cli.updata --filepath train.msgpack \
        --name hyres_n128_q1 --dir artifacts/
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="bake CDF tables into a deployable artifact")
    p.add_argument("--filepath", type=str, required=True, help="training checkpoint")
    p.add_argument("--name", type=str, default="model")
    p.add_argument("--dir", type=str, default=".")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=192)
    p.add_argument("--jpeg-quality", type=int, default=1)
    p.add_argument("--no-refit-quantiles", dest="refit_quantiles",
                   action="store_false", default=True,
                   help="skip the closed-form quantile refit before baking")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..entropy import (build_bottleneck_tables, build_gaussian_tables,
                           get_scale_table, refit_model_quantiles)
    from ..train import extract_variables, load_checkpoint, save_checkpoint

    variables = extract_variables(load_checkpoint(args.filepath))
    if args.refit_quantiles:
        variables = refit_model_quantiles(variables)
    tree = variables["params"]
    eb = (tree.get("residual_model", tree).get("entropy_bottleneck")
          if isinstance(tree, dict) else None)
    if eb is None:
        raise SystemExit("checkpoint has no entropy_bottleneck parameters")

    gauss = build_gaussian_tables(get_scale_table())
    ebt = build_bottleneck_tables(eb)
    out = {
        "params": tree,
        "tables": {
            "gaussian": {"quantized_cdf": gauss.quantized_cdf,
                         "cdf_length": gauss.cdf_length, "offset": gauss.offset},
            "bottleneck": {"quantized_cdf": ebt.quantized_cdf,
                           "cdf_length": ebt.cdf_length, "offset": ebt.offset},
        },
        "config": {"N": args.N, "M": args.M, "jpeg_quality": args.jpeg_quality},
    }
    path = Path(args.dir) / f"{args.name}.msgpack"
    Path(args.dir).mkdir(parents=True, exist_ok=True)
    save_checkpoint(out, path)
    print(f"saved deployable artifact with baked CDFs to {path}")


if __name__ == "__main__":
    main()
