"""Ranks of the gloo groups that ``tests/test_torch_parallel.py`` spawns.

Spawned children start from a fresh import of this module, so it imports
neither JAX nor the JAX package (forking a process that has imported
JAX is unsafe). ``run_ranks`` starts the ranks with the ``spawn`` method,
joins them by a file rendezvous under a test's ``tmp_path`` (no TCP
port), bounds every collective by the group's timeout and the whole run
by a wall clock, and returns each rank's result. The helpers below also
give the single-process references the tests compare with.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

N, M, Q = 8, 12, 10
S = 64
LMBDA = 0.0483
GROUP_TIMEOUT_S = 60
WALL_S = 90.0


def run_ranks(fn, world: int, tmp: Path, *args, wall: float = WALL_S) -> list:
    """fn(rank, world, *args) on ``world`` spawned gloo ranks -> results."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(tmp), args, torch.get_num_threads()))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + wall
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still ran after {wall} s"
    errors = {r: (tmp / f"rank{r}.err").read_text() for r in range(world)
              if (tmp / f"rank{r}.err").exists()}
    assert all(p.exitcode == 0 for p in procs) and not errors, (
        [p.exitcode for p in procs], errors)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _rank_main(fn, rank: int, world: int, tmp: str, args, threads: int) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        torch.save(fn(rank, world, *args), Path(tmp) / f"rank{rank}.pt")
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# -- helpers shared with the single-process references -------------------------


def images(B: int, seed: int = 0, h: int = S, w: int = S) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((B, h, w, 3)).astype(np.float32))


def hyres_model(seed: int = 0):
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.nn import init_parameters

    return init_parameters(ResidualJPEGCompression(N, M, Q), torch.Generator().manual_seed(seed))


def checkerboard_model(seed: int = 0, n: int = N, m: int = M):
    from hyres_tpu_torch.models import LightWeightCheckerboard
    from hyres_tpu_torch.nn import init_parameters

    return init_parameters(LightWeightCheckerboard(n, m), torch.Generator().manual_seed(seed))


def train_state(model):
    from hyres_tpu_torch.train import configure_optimizers, create_train_state

    main, aux = configure_optimizers(model, 1e-4, 1e-3, 1.0)
    return create_train_state(model, main, aux)


def refine_step(model, dp=None):
    from hyres_tpu_torch.cli.refine_training import freeze_codec, make_refine_step

    opt = torch.optim.Adam(freeze_codec(model), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    return make_refine_step(model, opt, dp=dp)


def snapshot(model, metrics: dict) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def train_once(dp, B: int, accum: int = 1, poison_row: int | None = None) -> dict:
    """One RD step of the seeded model on the seeded global batch (noise
    mode, generator seeded 3): the metrics, gradients and parameters."""
    from hyres_tpu_torch.train import make_train_step

    model = hyres_model()
    step = make_train_step(train_state(model), LMBDA, accum_steps=accum, dp=dp)
    x = images(B)
    if poison_row is not None:
        x[poison_row] = float("nan")
    return snapshot(model, step(x, torch.Generator().manual_seed(3), True))


def refine_once(dp, B: int) -> dict:
    model = hyres_model(1)
    return snapshot(model, refine_step(model, dp)(images(B, 1)))


# -- the ranks -----------------------------------------------------------------


def _dp():
    from hyres_tpu_torch.parallel import data_parallel_mesh

    return data_parallel_mesh("cpu")


def train_rank(rank, world, B, accum=1, poison_row=None):
    return train_once(_dp(), B, accum, poison_row)


def refine_rank(rank, world, B):
    return refine_once(_dp(), B)


def sharded_eval_rank(rank, world, family, B):
    from hyres_tpu_torch.parallel import make_sharded_eval

    model = hyres_model(2) if family == "hyres" else checkerboard_model(2)
    return make_sharded_eval(model, _dp())(images(B, 2))


def spatial_eval_rank(rank, world, H, halo):
    from hyres_tpu_torch.parallel import make_spatial_eval

    x_hat, bits = make_spatial_eval(checkerboard_model(4), _dp(), halo)(images(1, 4, H))
    return {"x_hat": x_hat, "bits": bits}


def clis_rank(rank, world, dataset, codec_ckpt, save_root, train_argv, refine_argv):
    """Both training CLIs in the group, each rank writing to its own
    directory: only rank 0's may hold anything."""
    from hyres_tpu_torch.cli import refine_training, training

    root = Path(save_root)
    training.main(["-d", dataset, "--savepath", str(root / f"train{rank}")] + train_argv)
    refine_training.main(["-d", dataset, "--checkpoint", codec_ckpt,
                          "--savepath", str(root / f"refine{rank}")] + refine_argv)
    return {"train": sorted(p.name for p in (root / f"train{rank}").glob("*")),
            "refine": sorted(p.name for p in (root / f"refine{rank}").glob("*"))}
