"""Training CLI: RD training of the HyRES composite codec on the port.

Counterpart of ``hyres_tpu/cli/training.py:30-328``, with the same flags
plus ``--device`` (``cuda``, the default, or ``cpu`` for tests; no card
raises). ``--cuda``, ``--gpu-id`` and ``--mps`` are accepted and ignored.
The schedule is the reference's: noise quantization until
``--noise-epochs``, then STE; the main learning rate x0.1 at that switch
in fresh runs; ReduceLROnPlateau (patience 10, factor 0.3, floored at
``--min-lr``) in ``--pretrained`` runs; eval every ``--eval-every`` and
checkpoints every ``--save-every`` epochs, one ``checkpoint_last_*`` and
one ``checkpoint_best_*`` kept, ``best_metrics.csv`` and ``best_images/``
beside them. ``--checkpoint`` resumes a port checkpoint (weights, both
optimizers, epoch); with ``--pretrained`` it takes the weights only, from
either package's file. Datasets are PNG folders ``DIR/{train,test}``.
``--alpha > 0`` adds the VGG16 perceptual term (``losses/vgg.py``) on
the weights of ``HYRES_VGG16_WEIGHTS``; without them it refuses to train
unless ``--allow-random-vgg`` is given, as the reference does.

    python -m hyres_tpu_torch.cli.training -d DIR --device cuda \\
        --epochs 4000 --batch-size 16 --lambda 0.015 --savepath ckpt/

With ``--gradient-accumulation-steps K`` a step takes K micro-batches of
``--batch-size`` (the loader yields K * batch-size images a step). The
metrics stay on the device between the prints every 100 steps.

Data parallel under ``torchrun`` (``parallel/``): one process a device,
NCCL on cards (``cuda:{LOCAL_RANK}``), gloo with ``--device cpu``.
``--batch-size`` stays the global batch: every rank runs the same seeded
loader and generator and trains on its rows of each micro-batch, so a
step is the single process's. Rank 0 alone prints, logs, evaluates and
writes; its eval metrics are broadcast, so every rank takes the same
learning-rate and checkpoint decisions.

    torchrun --nproc_per_node=8 -m hyres_tpu_torch.cli.training -d DIR ...
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    from .inference import add_cheng_variant

    p = argparse.ArgumentParser(description="HyRES training on the PyTorch port")
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="root with train/ and test/ PNG folders")
    p.add_argument("--model", type=str, default="hyres",
                   choices=["hyres", "checkerboard", "elic", "cheng2020"],
                   help="model family (hyres = JPEG base + residual codec)")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=192)
    p.add_argument("--jpeg-quality", type=int, default=1)
    add_cheng_variant(p)
    p.add_argument("-e", "--epochs", type=int, default=4000)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--lambda", dest="lmbda", type=float, default=0.015)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="VGG perceptual weight; the production recipe uses 0. alpha>0 "
                        "requires pretrained VGG16 weights (HYRES_VGG16_WEIGHTS) unless "
                        "--allow-random-vgg is passed.")
    p.add_argument("--allow-random-vgg", action="store_true",
                   help="permit alpha>0 with random (untrained) VGG features")
    p.add_argument("-n", "--num-workers", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--test-batch-size", type=int, default=8)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=1926)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--pretrained", action="store_true",
                   help="phase continuation: weights only, fresh epoch/lr, plateau scheduler")
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--mixed-precision", action="store_true",
                   help="bf16 activations through g_a/g_s/h_a/h_s and the refinement, "
                        "float32 parameters and entropy tails")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' (for tests)")
    p.add_argument("--cuda", action="store_true", help="ignored (see --device)")
    p.add_argument("--mps", action="store_true", help="ignored")
    p.add_argument("--gpu-id", type=str, default="0", help="ignored")
    p.add_argument("--savepath", type=str, default="./checkpoints")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--logdir", type=str, default=None, help="TensorBoard log directory")
    p.add_argument("--noise-epochs", type=int, default=400,
                   help="epochs of noise quantization before the STE switch")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="cap on steps an epoch")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (activation memory)")
    p.add_argument("--min-lr", type=float, default=1e-6,
                   help="floor of the plateau scheduler in --pretrained runs")
    p.add_argument("--save-every", type=int, default=1, help="checkpoint every N epochs")
    p.add_argument("--eval-every", type=int, default=1,
                   help="held-out eval every N epochs (checkpoints and the plateau "
                        "scheduler only run on eval epochs)")
    p.add_argument("--augment", action="store_true",
                   help="dihedral (flip/rotate) crop augmentation")
    p.add_argument("--augment-scale", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="resample each source by a log-uniform factor in [LO, HI] "
                        "before cropping")
    return p.parse_args(argv)


def _build_model(args):
    from ..models import (Cheng2020withCheckerboard, LightWeightCheckerboard,
                          LightWeightELIC, ResidualJPEGCompression)

    cd = torch.bfloat16 if args.mixed_precision else None
    if args.model == "hyres":
        return ResidualJPEGCompression(args.N, args.M, args.jpeg_quality, compute_dtype=cd)
    if args.model == "checkerboard":
        return LightWeightCheckerboard(args.N, args.M, compute_dtype=cd)
    # the baseline families' own defaults stand in for the flags' (N 128 ->
    # 192, M 192 -> 320), as the reference's CLI does
    if args.model == "elic":
        return LightWeightELIC(args.N if args.N != 128 else 192,
                               args.M if args.M != 192 else 320, compute_dtype=cd)
    from .inference import CHENG_VARIANTS

    return Cheng2020withCheckerboard(args.N if args.N != 128 else 192, compute_dtype=cd,
                                     **CHENG_VARIANTS[args.cheng_variant])


def _test_batches(test_set, batch_size: int, device) -> list:
    """Full test images, grouped into batches of one shape."""
    out, buf = [], []
    for i in range(len(test_set)):
        buf.append(test_set.load(i, np.random.default_rng(0)))
        if len(buf) == batch_size:
            out += [np.stack(buf)] if len({b.shape for b in buf}) == 1 else [b[None] for b in buf]
            buf = []
    out += [b[None] for b in buf]
    return [torch.from_numpy(b).to(device) for b in out]


def _upload(batch: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(batch)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _save_best_images(eval_fn, batch: torch.Tensor, img_dir: Path) -> None:
    """Reconstructions of the first test images (residuals as x*0.5+0.5)."""
    from ..train import save_image

    img_dir.mkdir(exist_ok=True)
    _, out = eval_fn(batch)
    for i in range(min(6, batch.shape[0])):
        save_image(out["x_hat"][i], img_dir / f"{i}_recon.png")
        save_image(batch[i], img_dir / f"{i}_original.png")
        if "jpeg_decoded" in out:
            save_image(out["jpeg_decoded"][i], img_dir / f"{i}_jpeg.png")
            save_image(out["residual"][i] * 0.5 + 0.5, img_dir / f"{i}_residual.png")
            save_image(out["residual_hat"][i] * 0.5 + 0.5, img_dir / f"{i}_residual_hat.png")


def main(argv=None):
    args = parse_args(argv)
    model = _build_model(args)

    from ..losses import VGGLoss
    from ..nn import init_parameters
    from ..parallel import (broadcast_object, data_parallel_mesh, local_device,
                            maybe_initialize_distributed, replicate)
    from ..train import (DataLoader, ImageFolder, Plateau, configure_optimizers,
                         create_train_state, delete_by_prefix, get_main_lr, load_checkpoint,
                         make_eval_step, make_train_step, restore_into, restore_train_state,
                         run_eval, save_checkpoint, set_main_lr, train_checkpoint)
    from ..utils.device import resolve_device
    from ..utils.logging import ScalarLogger

    owns_group = maybe_initialize_distributed(args.device)
    device = resolve_device(local_device(args.device))
    dp = data_parallel_mesh(device)
    say = print if dp.is_main else (lambda *a, **k: None)
    logger = ScalarLogger(args.logdir if dp.is_main else None)
    save_dir = Path(args.savepath)
    if dp.is_main:
        save_dir.mkdir(parents=True, exist_ok=True)

    accum = args.gradient_accumulation_steps
    train_set = ImageFolder(args.dataset, "train", tuple(args.patch_size), train=True,
                            augment=args.augment,
                            scale_range=tuple(args.augment_scale) if args.augment_scale else None)
    test_set = ImageFolder(args.dataset, "test", None, train=False)
    train_loader = DataLoader(train_set, args.batch_size * accum, seed=args.seed,
                              num_workers=args.num_workers)

    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"model: N={model.N} M={model.M} q={args.jpeg_quality} "
        f"({n_params / 1e6:.2f}M params) device={device} ranks={dp.world}")
    main_opt, aux_opt = configure_optimizers(model, args.learning_rate,
                                             args.aux_learning_rate, args.clip_max_norm)
    state = create_train_state(model, main_opt, aux_opt)

    start_epoch = 0
    best_loss = float("inf")
    if args.checkpoint:
        raw = load_checkpoint(args.checkpoint)
        if args.pretrained:
            restore_into(model, raw)
            say(f"loaded pretrained weights from {args.checkpoint} (stemode)")
        else:
            restore_train_state(state, raw)
            start_epoch = int(raw.get("epoch", 0)) + 1
            best_loss = float(raw.get("best_loss", best_loss))
            say(f"resumed from {args.checkpoint} at epoch {start_epoch}")
    replicate(dp, model)

    vgg_fn = VGGLoss().to(device) if args.alpha else None
    if vgg_fn is not None and not vgg_fn.pretrained:
        if not args.allow_random_vgg:
            raise SystemExit(
                "alpha>0 but no pretrained VGG16 weights are available "
                "(HYRES_VGG16_WEIGHTS unset or missing). Training a "
                "'perceptual' loss against random features is almost "
                "certainly not what you want — set HYRES_VGG16_WEIGHTS to "
                "a torch-layout .npz, use --alpha 0 (the production "
                "recipe, reference train.sh:9), or pass --allow-random-vgg "
                "to override.")
        say("WARNING: no VGG16 weights (HYRES_VGG16_WEIGHTS unset); "
            "perceptual term uses random features (--allow-random-vgg)")
    step_fn = make_train_step(state, lmbda=args.lmbda, alpha=args.alpha, vgg_fn=vgg_fn,
                              accum_steps=accum, remat=args.remat, dp=dp)
    eval_fn = make_eval_step(model, lmbda=args.lmbda, alpha=args.alpha, vgg_fn=vgg_fn)
    test_batches = (_test_batches(test_set, args.test_batch_size, device)
                    if dp.is_main else [])
    generator = torch.Generator(device).manual_seed(args.seed)

    plateau = Plateau(patience=10, floor=args.min_lr)
    best_saved_loss = best_loss
    try:
        for epoch in range(start_epoch, args.epochs):
            noisequant = (epoch < args.noise_epochs) and not args.pretrained
            if not args.pretrained and epoch == args.noise_epochs:  # MultiStep x0.1
                set_main_lr(main_opt, args.learning_rate * 0.1)
            t0 = time.time()
            n_steps = 0
            runs = torch.zeros(3, device=device)  # loss, bpp, mse: summed on the device
            for bi, batch in enumerate(train_loader):
                if args.steps_per_epoch and bi >= args.steps_per_epoch:
                    break
                if batch.shape[0] != args.batch_size * accum:
                    continue
                m = step_fn(_upload(batch, device), generator, noisequant)
                n_steps += 1
                runs += torch.stack([m["loss"], m["bpp_loss"], m["mse_loss"]])
                if bi % 100 == 0:
                    say(f"epoch {epoch} [{bi}/{len(train_loader)}] "
                        f"loss={float(m['loss']):.4f} mse={float(m['mse_loss']):.4f} "
                        f"bpp={float(m['bpp_loss']):.4f} aux={float(m['aux_loss']):.1f} "
                        f"lr={get_main_lr(main_opt):.2e} noise={noisequant}", flush=True)
            run_loss, run_bpp, run_mse = (float(v) / max(n_steps, 1) for v in runs)
            logger.log("Train", {"loss": run_loss, "mse": run_mse, "bpp": run_bpp}, epoch)
            if epoch % args.eval_every and epoch != args.epochs - 1:
                say(f"epoch {epoch}: train_loss={run_loss:.4f} "
                    f"({time.time() - t0:.1f}s)", flush=True)
                continue
            # computed once and broadcast: cuDNN's autotuned algorithms can
            # differ in the last bits between cards, and every rank must take
            # the same learning-rate and checkpoint decisions
            eval_metrics = broadcast_object(
                dp, run_eval(eval_fn, test_batches) if dp.is_main else None)
            loss = eval_metrics["loss"]
            logger.log("Test", eval_metrics, epoch)
            say(f"epoch {epoch}: train_loss={run_loss:.4f} test_loss={loss:.4f} "
                f"test_psnr={eval_metrics['psnr']:.2f} "
                f"test_bpp={eval_metrics['bpp_loss']:.4f} ({time.time() - t0:.1f}s)",
                flush=True)

            if args.pretrained:  # ReduceLROnPlateau(patience=10, factor=0.3)
                new_lr = plateau.update(loss, get_main_lr(main_opt))
                if new_lr is not None:
                    set_main_lr(main_opt, new_lr)
                    say(f"plateau: lr -> {new_lr:.2e}")

            # compare against the best SAVED loss, so that a best reached
            # between save points is still written at the next one
            best_loss = min(best_loss, loss)
            if epoch % args.save_every and epoch != args.epochs - 1:
                continue
            is_best = loss < best_saved_loss
            if is_best:
                best_saved_loss = loss
            if not dp.is_main:
                continue
            ckpt = train_checkpoint(state, epoch, loss, best_loss)
            delete_by_prefix(save_dir, "checkpoint_last_")
            save_checkpoint(ckpt, save_dir / f"checkpoint_last_{epoch}.msgpack")
            if is_best:
                delete_by_prefix(save_dir, "checkpoint_best_")
                save_checkpoint(ckpt, save_dir / f"checkpoint_best_{epoch}.msgpack")
                with open(save_dir / "best_metrics.csv", "w", newline="") as f:
                    w = csv.writer(f)
                    w.writerow(sorted(eval_metrics))
                    w.writerow([eval_metrics[k] for k in sorted(eval_metrics)])
                _save_best_images(eval_fn, test_batches[0], save_dir / "best_images")
    finally:
        train_loader.close()
        logger.close()
        if owns_group:
            torch.distributed.destroy_process_group()
    say("training done")


if __name__ == "__main__":
    main()
