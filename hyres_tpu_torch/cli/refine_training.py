"""Refinement training CLI: the frozen-codec refinement phase on the port.

Counterpart of ``hyres_tpu/cli/refine_training.py`` (the reference's
``post_train.sh``), with the same flags plus ``--device`` (``cuda``, the
default, or ``cpu``; no card raises). It loads a codec checkpoint of
either package (or a trained artifact), overlays a refine-only checkpoint
with ``--resume``, and trains the ``refine`` subtree alone on
``mean((x_hat - x)^2) * 255^2`` of the deterministic training forward
(``noisequant=False``: no draw, z rounds about its medians).

Every parameter outside ``refine.*`` (``refine_mask``) is frozen with
``requires_grad_(False)``: the backward never enters the codec and no
optimizer holds its leaves. The reference computes every gradient and
zeroes the frozen ones (``optax.multi_transform``); the refine gradients
are the same. The refine leaves take Adam (0.9/0.999, eps 1e-8;
``train/optimizers.py adam``) after a global-norm clip of 1.0 over the
refine gradients alone. A step whose updated parameters are not all
finite is undone on the device, as JAX selects it: the refine parameters
and the Adam state go back to a snapshot (``train/engine.py NanGuard``),
with no host read. The step runs under
``train/engine.py train_numerics``. The eval is the mean MSE x 255^2 and
PSNR over the full test images; more than 5 evals without a better loss
multiply the rate by 0.3, floored at 1e-6. Each epoch writes a
refine-only checkpoint ``{"epoch", "params": {"refine": ...}, "loss"}``
in flax layout, ``refine_last_{epoch}.msgpack`` and, on a new best,
``refine_best_{epoch}.msgpack``, which either package's
``refine_inference`` reads. Datasets are PNG folders ``DIR/{train,test}``.
Under ``torchrun`` the step is data parallel as ``cli/training.py``'s
(one process a device, ``--batch-size`` the global batch, rank 0 alone
evaluates, prints and writes, its eval broadcast to every rank).

    python -m hyres_tpu_torch.cli.refine_training -d DIR --device cuda \\
        --checkpoint artifacts/hyres_n128_q1_l0032.msgpack --savepath refine/
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch import nn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HyRES refinement training on the PyTorch port")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="codec checkpoint (full model weights)")
    p.add_argument("--resume", type=str, default=None,
                   help="refine-only checkpoint to resume from")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=192)
    p.add_argument("--jpeg-quality", type=int, default=1)
    p.add_argument("-e", "--epochs", type=int, default=100)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=1926)
    p.add_argument("--savepath", type=str, default="./refine_checkpoints")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (for tests)")
    return p.parse_args(argv)


def refine_mask(model: nn.Module) -> Dict[str, bool]:
    """True only for the parameters under the top-level ``refine`` module."""
    return {name: "refine" in name.split(".") for name, _ in model.named_parameters()}


def freeze_codec(model: nn.Module) -> List[nn.Parameter]:
    """Freeze every parameter outside ``refine``; the trainable ones."""
    mask = refine_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return [p for name, p in model.named_parameters() if mask[name]]


def load_refine(model: nn.Module, raw: dict) -> None:
    """Overlay the refine subtree of a refine-only (or full) checkpoint."""
    from ..train import extract_variables
    from ..utils.convert import from_flax

    tree = extract_variables(raw)["params"]
    model.refine.load_state_dict(from_flax(tree.get("refine", tree)), strict=True)


def refine_checkpoint(model: nn.Module, epoch: int, loss: float) -> dict:
    """The refine-only checkpoint tree, in flax layout."""
    from ..utils.convert import to_flax

    return {"epoch": np.int64(epoch), "params": {"refine": to_flax(model.refine)},
            "loss": np.float64(loss)}


def make_refine_step(model: nn.Module, opt: torch.optim.Optimizer, dp=None):
    """step(batch) -> {"loss", "skipped_nonfinite"} (device tensors): one
    MSE step of the parameters ``opt`` holds, the rest frozen. Updates
    the model and ``opt`` in place; the tail runs on ``opt``'s flat
    buffers (``train/optimizers.py FlatAdam``), as the training step's.
    With ``dp`` (``parallel/mesh.py``) ``batch`` is the global batch: each
    rank runs its rows, weights its mean by their share, and the refine
    gradients (their flat buffer) and the loss are summed over the group
    (one all-reduce each) before the clip, so every rank takes the same
    update."""
    from ..parallel.mesh import all_reduce_grads_
    from ..train.engine import NanGuard, _all_finite, train_numerics
    from ..train.optimizers import OPTIM_STATS, bind_flat

    guard = NanGuard()
    flats = None

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        nonlocal flats
        model.train()
        n = batch.shape[0]
        lo, hi = (0, n) if dp is None else dp.rows(n)
        with train_numerics(batch.device):
            flats = bind_flat({"refine": opt}, flats)
            flat = flats[0]
            flat.zero_grad_()
            loss = torch.zeros((), device=batch.device)
            if hi > lo:
                x = batch[lo:hi]
                out = model(x, noisequant=False)
                loss = torch.mean((out["x_hat"] - x) ** 2) * 255.0 ** 2 * ((hi - lo) / n)
                loss.backward()
            if dp is not None:
                all_reduce_grads_(dp, flat.grads)
                loss = dp.all_reduce_(loss.detach().clone())
            guard.take(flat.live)
            flat.clip_()
            flat.step_()
            # the reference checks the UPDATED parameters: a gradient can
            # overflow the clip's norm while every gradient is finite
            finite = _all_finite(flat.values)
            guard.select(finite)
        OPTIM_STATS["flat_steps"] += 1
        return {"loss": loss.detach(), "skipped_nonfinite": (~finite).to(torch.float32)}

    return step


@torch.no_grad()
def refine_eval(model: nn.Module, batch: torch.Tensor):
    """(MSE x 255^2, PSNR) of the deterministic forward on ``batch``."""
    from ..train.engine import train_numerics

    model.eval()
    with train_numerics(batch.device):
        out = model(batch, noisequant=False)
    mse = torch.mean((out["x_hat"] - batch) ** 2)
    return mse * 255.0 ** 2, -10.0 * torch.log10(mse)


def main(argv=None):
    args = parse_args(argv)
    from ..models.hyres import ResidualJPEGCompression
    from ..parallel import (broadcast_object, data_parallel_mesh, local_device,
                            maybe_initialize_distributed, replicate)
    from ..train import (DataLoader, ImageFolder, Plateau, delete_by_prefix, load_checkpoint,
                         restore_into, save_checkpoint)
    from ..train.optimizers import adam
    from ..utils.device import resolve_device
    from .training import _upload

    owns_group = maybe_initialize_distributed(args.device)
    device = resolve_device(local_device(args.device))
    dp = data_parallel_mesh(device)
    say = print if dp.is_main else (lambda *a, **k: None)
    save_dir = Path(args.savepath)
    if dp.is_main:
        save_dir.mkdir(parents=True, exist_ok=True)

    model = ResidualJPEGCompression(args.N, args.M, args.jpeg_quality)
    restore_into(model, load_checkpoint(args.checkpoint))
    if args.resume:
        load_refine(model, load_checkpoint(args.resume))
    model.to(device)
    replicate(dp, model)
    params = freeze_codec(model)
    say(f"training {sum(p.numel() for p in params) / 1e6:.3f}M refine params "
        f"(codec frozen) device={device} ranks={dp.world}")
    opt = adam(params, args.learning_rate)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    step = make_refine_step(model, opt, dp=dp)

    train_set = ImageFolder(args.dataset, "train", tuple(args.patch_size), train=True)
    test_set = ImageFolder(args.dataset, "test", None, train=False)
    loader = DataLoader(train_set, args.batch_size, seed=args.seed)
    test_imgs = [torch.from_numpy(test_set.load(i, np.random.default_rng(0))[None]).to(device)
                 for i in range(len(test_set) if dp.is_main else 0)]

    best = float("inf")
    plateau = Plateau(patience=5, floor=1e-6)
    try:
        for epoch in range(args.epochs):
            t0 = time.time()
            run, n = torch.zeros((), device=device), 0
            for bi, batch in enumerate(loader):
                if args.steps_per_epoch and bi >= args.steps_per_epoch:
                    break
                run += step(_upload(batch, device))["loss"]
                n += 1
            evals = [refine_eval(model, b) for b in test_imgs]
            # computed once and broadcast, so every rank decides alike
            val, psnr = broadcast_object(dp, (
                float(np.mean([float(v[0]) for v in evals])),
                float(np.mean([float(v[1]) for v in evals]))) if dp.is_main else None)
            lr = opt.param_groups[0]["lr"]
            say(f"epoch {epoch}: train_mse={float(run) / max(n, 1):.3f} val_mse={val:.3f} "
                f"val_psnr={psnr:.2f} lr={lr:.2e} ({time.time() - t0:.1f}s)", flush=True)
            new_lr = plateau.update(val, lr)
            if new_lr is not None:
                opt.param_groups[0]["lr"] = new_lr
            if not dp.is_main:
                continue

            ckpt = refine_checkpoint(model, epoch, val)
            delete_by_prefix(save_dir, "refine_last_")
            save_checkpoint(ckpt, save_dir / f"refine_last_{epoch}.msgpack")
            if val < best:
                best = val
                delete_by_prefix(save_dir, "refine_best_")
                save_checkpoint(ckpt, save_dir / f"refine_best_{epoch}.msgpack")
    finally:
        loader.close()
        if owns_group:
            torch.distributed.destroy_process_group()
    say("refine training done")


if __name__ == "__main__":
    main()
