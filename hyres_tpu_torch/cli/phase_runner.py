"""Multi-phase lambda-schedule runner on the port.

Counterpart of ``hyres_tpu/cli/phase_runner.py``: the reference's
production recipe trains once per lambda in {0.045, 0.032, 0.016, 0.008,
0.004, 0.002}, each phase from the previous phase's best checkpoint with
``--pretrained``. This chains the port's ``cli/training.py`` over the
list: phase directories ``phase{i}_{lambda}`` under ``--savepath``, a
fresh first phase of ``--first-phase-epochs`` (default twice
``--epochs-per-phase``) unless ``--init-checkpoint`` chains it too, and
``--passthrough`` flags (``--device cpu``, say) forwarded to every phase.

    python -m hyres_tpu_torch.cli.phase_runner -d DIR --savepath phases/ \\
        --passthrough --device cuda --batch-size 16
"""

from __future__ import annotations

import argparse
from pathlib import Path

DEFAULT_LAMBDAS = (0.045, 0.032, 0.016, 0.008, 0.004, 0.002)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="automated multi-phase RD training")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--lambdas", type=float, nargs="+", default=list(DEFAULT_LAMBDAS))
    p.add_argument("--epochs-per-phase", type=int, default=400)
    p.add_argument("--first-phase-epochs", type=int, default=None,
                   help="epochs for the fresh first phase (default: 2x per-phase)")
    p.add_argument("--savepath", type=str, default="./phases")
    p.add_argument("--init-checkpoint", type=str, default=None,
                   help="chain the FIRST phase from this checkpoint instead of "
                        "training it fresh")
    p.add_argument("--passthrough", nargs=argparse.REMAINDER, default=[],
                   help="extra flags forwarded to every training invocation")
    return p.parse_args(argv)


def _best_checkpoint(directory: Path) -> Path:
    cands = sorted(directory.glob("checkpoint_best_*.msgpack"))
    if not cands:
        cands = sorted(directory.glob("checkpoint_last_*.msgpack"))
    if not cands:
        raise RuntimeError(f"phase produced no checkpoint in {directory}")
    return cands[-1]


def main(argv=None):
    args = parse_args(argv)
    from .training import main as train_main

    root = Path(args.savepath)
    prev_best: Path | None = Path(args.init_checkpoint) if args.init_checkpoint else None
    for phase, lmbda in enumerate(args.lambdas):
        phase_dir = root / f"phase{phase}_{lmbda}"
        phase_dir.mkdir(parents=True, exist_ok=True)
        fresh = phase == 0 and args.init_checkpoint is None
        epochs = ((args.first_phase_epochs or 2 * args.epochs_per_phase) if fresh
                  else args.epochs_per_phase)
        cmd = ["-d", args.dataset, "--lambda", str(lmbda), "-e", str(epochs),
               "--savepath", str(phase_dir), *args.passthrough]
        if prev_best is not None:
            cmd += ["--pretrained", "--checkpoint", str(prev_best)]
        print(f"=== phase {phase}: lambda={lmbda} epochs={epochs} "
              f"{'(chained from ' + str(prev_best) + ')' if prev_best else '(fresh)'}")
        train_main(cmd)
        prev_best = _best_checkpoint(phase_dir)
    print(f"all phases done; final best: {prev_best}")


if __name__ == "__main__":
    main()
