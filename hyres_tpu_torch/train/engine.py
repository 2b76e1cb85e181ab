"""Training engine: the RD train step, the eval step and the eval loop.

Counterpart of ``hyres_tpu/train/engine.py:34-158``. One step, in the
reference's order: the main loss's gradients (averaged over
``accum_steps`` micro-batches, each with its own draws from the step's
generator); a finiteness check over all gradients; the main partition's
global-norm clip; the main Adam step; the aux (quantile) loss on the
updated parameters; the aux Adam step. A non-finite gradient skips both
optimizer steps, so neither the parameters nor either optimizer's state
moves. The finiteness flag is the step's one host read; the metrics stay
on the device.

``remat`` runs the forward under ``torch.utils.checkpoint``
(non-reentrant). The noise of a micro-batch is drawn before the
checkpointed region and handed in as tensors, since a recompute would
draw again from an explicit generator (checkpoint restores only the
default generators' state).

On a card the step runs under a scoped ``torch.backends.cudnn.flags``:
autotuned, non-deterministic convolution algorithms (training does not
face the coder), TF32 off so float32 stays float32. The process-wide
flags that the coder path sets (``utils/device.py``) are back as they
were when the step returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from ..losses import AverageMeter, rate_distortion_loss
from .optimizers import clip_main_grads_

METRICS = ("loss", "mse_loss", "vgg_loss", "bpp_loss", "residual_bpp_loss",
           "jpeg_bpp_loss", "y_bpp_loss", "z_bpp_loss")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    main: torch.optim.Optimizer
    aux: torch.optim.Optimizer
    step: int = 0


create_train_state = TrainState  # the reference's name


@contextlib.contextmanager
def train_numerics(device: torch.device):
    """cuDNN autotuned and non-deterministic, TF32 off, for the scope only."""
    if torch.device(device).type != "cuda":
        yield
        return
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        yield


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def make_train_step(state: TrainState, lmbda: float, alpha: float = 0.0,
                    vgg_fn: Callable | None = None, accum_steps: int = 1,
                    remat: bool = False):
    """step(batch, generator, noisequant) -> metrics (device tensors).

    ``batch``: (accum_steps * B, H, W, 3) NHWC in [0, 1] on the model's
    device. ``generator`` (or None: no noise, z rounds about its medians)
    feeds every draw. Updates ``state`` in place."""
    model, main, aux = state.model, state.main, state.aux
    params = [p for g in main.param_groups + aux.param_groups for p in g["params"]]

    def step(batch: torch.Tensor, generator: torch.Generator | None,
             noisequant: bool) -> Dict[str, torch.Tensor]:
        model.train()
        with train_numerics(batch.device):
            main.zero_grad(set_to_none=True)
            aux.zero_grad(set_to_none=True)
            sums = {k: torch.zeros((), device=batch.device) for k in METRICS}
            for mb in batch.chunk(accum_steps):
                noise = (None if generator is None else
                         model.draw_noise(mb.shape, generator, noisequant, mb.device))
                out = model(mb, noisequant=noisequant, noise=noise, remat=remat)
                d = rate_distortion_loss(out, mb, lmbda=lmbda, alpha=alpha, vgg_fn=vgg_fn)
                (d["loss"] / accum_steps).backward()
                for k in METRICS:
                    sums[k] += d[k].detach()
            metrics = {k: v / accum_steps for k, v in sums.items()}
            for p in params:  # the reference's gradient of an unused leaf is 0
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            finite = _all_finite([p.grad for p in params])
            if bool(finite):  # the step's one host read
                clip_main_grads_(main)
                main.step()
                aux.zero_grad(set_to_none=True)
                aux_val = model.aux_loss()
                aux_val.backward()
                aux.step()
            else:
                with torch.no_grad():
                    aux_val = model.aux_loss()
        state.step += 1
        metrics["aux_loss"] = aux_val.detach()
        metrics["skipped_nonfinite"] = (~finite).to(torch.float32)
        return metrics

    return step


def make_eval_step(model: nn.Module, lmbda: float, alpha: float = 0.0,
                   vgg_fn: Callable | None = None):
    """eval_step(batch) -> (metrics with ``psnr``, forward output), with
    rounding quantization and no gradient."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor):
        model.eval()
        with train_numerics(batch.device):
            out = model(batch, noisequant=False)
            d = rate_distortion_loss(out, batch, lmbda=lmbda, alpha=alpha, vgg_fn=vgg_fn)
            mse = torch.mean((out["x_hat"] - batch) ** 2, dim=(1, 2, 3))
            d["psnr"] = torch.mean(-10.0 * torch.log10(mse))
        return d, out

    return eval_step


def run_eval(eval_step, batches) -> Dict[str, float]:
    """Metrics averaged over the validation batches (weighted by size)."""
    meters: Dict[str, AverageMeter] = {}
    for batch in batches:
        d, _ = eval_step(batch)
        for k, v in d.items():
            meters.setdefault(k, AverageMeter()).update(float(v), batch.shape[0])
    return {k: m.avg for k, m in meters.items()}
