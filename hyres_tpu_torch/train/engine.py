"""Training engine: the RD train step, the eval step and the eval loop.

Counterpart of ``hyres_tpu/train/engine.py:34-158``. One step, in the
reference's order: the main loss's gradients (averaged over
``accum_steps`` micro-batches, each with its own draws from the step's
generator); a finiteness check over all gradients; the main partition's
global-norm clip; the main Adam step; the aux (quantile) loss on the
updated parameters; the aux Adam step. A non-finite gradient skips both
optimizer steps as JAX does, on the device: the steps run on zeroed
gradients, ``aux_loss`` is taken at those parameters, and then the
parameters and both optimizers' states are selected back to a snapshot
taken before them (``NanGuard``), so neither moves. The step reads
nothing on the host when its Adams are ``optimizers.adam``'s (capturable
on a card); the metrics stay on the device.

The tail after the backward runs on each partition's flat buffers
(``optimizers.FlatAdam``, bound at the first step): one finiteness
reduction over both gradient buffers, one snapshot copy, a masked fill, a
clip and an Adam step a buffer, and one select a state buffer, whatever
the number of leaves. The gradient buffers are zeroed before the forward
and autograd adds into the leaves' ``.grad`` views.

``remat`` runs the forward under ``torch.utils.checkpoint``
(non-reentrant). The noise of a micro-batch is drawn before the
checkpointed region and handed in as tensors, since a recompute would
draw again from an explicit generator (checkpoint restores only the
default generators' state).

With ``dp`` (``parallel/mesh.py DataParallel``) every rank takes the
same global batch and the same generator state: each global micro-batch's
noise is drawn whole and sliced to the rank's rows, so the draws are the
single process's; the rank's mean loss is weighted by its share of the
rows. The gradients are summed over the group, one all-reduce a flat
gradient buffer, before the finiteness check, so the check, the clip and
both Adams decide alike on every rank and the parameters stay identical;
the metrics are summed in one more, so they are the global batch's.

On a card the step runs under a scoped ``torch.backends.cudnn.flags``:
autotuned, non-deterministic convolution algorithms (training does not
face the coder), TF32 off so float32 stays float32. The process-wide
flags that the coder path sets (``utils/device.py``) are back as they
were when the step returns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from ..losses import AverageMeter, rate_distortion_loss
from ..utils.device import autotuned_float32
from ..utils.trace import span
from .optimizers import OPTIM_STATS, bind_flat

METRICS = ("loss", "mse_loss", "vgg_loss", "bpp_loss", "residual_bpp_loss",
           "jpeg_bpp_loss", "y_bpp_loss", "z_bpp_loss")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    main: torch.optim.Optimizer
    aux: torch.optim.Optimizer
    step: int = 0

    def replace(self, **changes) -> "TrainState":
        """A copy with ``changes`` (flax's ``struct`` method)."""
        return dataclasses.replace(self, **changes)


create_train_state = TrainState  # the reference's name


# cuDNN autotuned and non-deterministic, TF32 off, for the scope only
train_numerics = autotuned_float32


def _all_finite(tensors) -> torch.Tensor:
    """True iff every element is finite: the largest |value| of each tensor
    (one foreach launch on a card; NaN and inf propagate) less itself is 0."""
    m = torch.stack(torch._foreach_norm(list(tensors), float("inf")))
    return (m - m == 0).all()


class NanGuard:
    """JAX's select of the old state on a non-finite step (``_where_tree``),
    on the device: ``take(live)`` copies the tensors ``live`` (the flat
    parameter and Adam state buffers) in one foreach copy;
    ``select(finite)`` keeps each tensor's new value where ``finite``
    holds and its copy elsewhere. No host read, unless an Adam keeps its
    step counts on the host while the flag is on a card."""

    def __init__(self):
        self.live: list = []
        self.saved: list = []

    def take(self, live) -> None:
        live = list(live)
        if len(live) != len(self.live) or any(a is not b for a, b in zip(live, self.live)):
            self.live, self.saved = live, [torch.empty_like(t) for t in live]
        with torch.no_grad():
            torch._foreach_copy_(self.saved, live)

    def select(self, finite: torch.Tensor) -> None:
        with torch.no_grad():
            for new, old in zip(self.live, self.saved):
                torch.where(finite.to(new.device), new, old, out=new)


def _noise_rows(noise, lo: int, hi: int, n: int):
    """Rows [lo, hi) of a batch of ``n``'s draws: the bottleneck's ``z``
    draw is (C, 1, n * h * w), image-major; every other is NHWC."""
    if noise is None:
        return None
    out = {}
    for k, t in noise.items():
        if k == "z":
            C, _, L = t.shape
            out[k] = t.reshape(C, 1, n, L // n)[:, :, lo:hi].reshape(C, 1, -1)
        else:
            out[k] = t[lo:hi]
    return out


def make_train_step(state: TrainState, lmbda: float, alpha: float = 0.0,
                    vgg_fn: Callable | None = None, accum_steps: int = 1,
                    remat: bool = False, dp=None):
    """step(batch, generator, noisequant) -> metrics (device tensors).

    ``batch``: the global (accum_steps * B, H, W, 3) NHWC batch in [0, 1]
    on the model's device. ``generator`` (or None: no noise, z rounds
    about its medians) feeds every draw. ``dp``: a ``DataParallel`` whose
    ranks share the step (None: this process alone). Updates ``state`` in
    place."""
    from ..parallel.mesh import all_reduce_grads_  # parallel/ imports this module

    model, main, aux = state.model, state.main, state.aux
    guard = NanGuard()
    flats = None

    def step(batch: torch.Tensor, generator: torch.Generator | None,
             noisequant: bool) -> Dict[str, torch.Tensor]:
        nonlocal flats
        model.train()
        with span("train.step"), train_numerics(batch.device):
            flats = bind_flat({"main": main, "aux": aux}, flats)
            fmain, faux = flats
            fmain.zero_grad_()  # an unused leaf's gradient stays 0, as the reference's
            faux.zero_grad_()
            sums = {k: torch.zeros((), device=batch.device) for k in METRICS}
            for mb in batch.chunk(accum_steps):
                n = mb.shape[0]
                lo, hi = (0, n) if dp is None else dp.rows(n)
                with span("model.forward"):
                    noise = (None if generator is None else
                             model.draw_noise(mb.shape, generator, noisequant, mb.device))
                    if hi == lo:  # no rows here: this rank adds zeros
                        continue
                    w = (hi - lo) / n  # the rank's share of the global mean
                    out = model(mb[lo:hi], noisequant=noisequant,
                                noise=_noise_rows(noise, lo, hi, n), remat=remat)
                    d = rate_distortion_loss(out, mb[lo:hi], lmbda=lmbda, alpha=alpha,
                                             vgg_fn=vgg_fn)
                with span("model.backward"):
                    (d["loss"] * w / accum_steps).backward()
                for k in METRICS:
                    sums[k] += d[k].detach() * w
            grads = fmain.grads + faux.grads
            if dp is not None:
                with span("dp.all_reduce"):
                    all_reduce_grads_(dp, grads)
                    totals = dp.all_reduce_(torch.stack([sums[k] for k in METRICS]))
                sums = dict(zip(METRICS, totals))
            metrics = {k: v / accum_steps for k, v in sums.items()}
            with span("optim.guard"):
                finite = _all_finite(grads)
                guard.take(fmain.live + faux.live)
                bad = ~finite
                with torch.no_grad():  # JAX's safe gradients: zero where not finite
                    for g in grads:
                        g.masked_fill_(bad, 0.0)
            with span("optim.clip"):
                fmain.clip_()
            with span("optim.adam"):
                fmain.step_()
            with span("optim.aux"):
                faux.zero_grad_()
                aux_val = model.aux_loss()
                aux_val.backward()
                faux.step_()
            with span("optim.select"):
                guard.select(finite)
        state.step += 1
        OPTIM_STATS["flat_steps"] += 1
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
