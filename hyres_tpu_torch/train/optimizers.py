"""Two-optimizer split (counterpart of ``hyres_tpu/train/optimizers.py:27-93``).

Every ``quantiles`` parameter goes to an auxiliary Adam (default lr 1e-3)
that minimises the bottleneck's quantile-fitting loss; everything else
to the main Adam (default lr 1e-4). The split is asserted disjoint and
complete, and each optimizer holds only its own partition, so neither
can move the other's parameters.

The main chain clips its gradients by the global norm of the main
partition, by optax's rule ``g * min(1, max_norm / ||g||)`` (no epsilon);
the bound sits in the main optimizer's param group as ``clip_max_norm``
(0 turns clipping off).

``Plateau`` is the reference CLIs' ReduceLROnPlateau: after more than
``patience`` evaluations without a loss 1e-6 below the best, the rate is
multiplied by 0.3 (floored) and the count restarts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn


def is_quantile(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


def quantile_mask(model: nn.Module) -> dict:
    """Each parameter name -> True under a ``quantiles`` key (the
    auxiliary optimizer's partition)."""
    return {name: is_quantile(name) for name, _ in model.named_parameters()}


def split_parameters(model: nn.Module) -> Tuple[List[torch.nn.Parameter],
                                                List[torch.nn.Parameter]]:
    """(main, aux) parameter lists: aux holds every ``quantiles``."""
    named = list(model.named_parameters())
    main = [p for n, p in named if not is_quantile(n)]
    aux = [p for n, p in named if is_quantile(n)]
    ids_main, ids_aux = {id(p) for p in main}, {id(p) for p in aux}
    if ids_main & ids_aux or len(ids_main | ids_aux) != len({id(p) for _, p in named}):
        raise AssertionError("main/aux parameter split is not disjoint and complete")
    return main, aux


def adam(params, lr: float) -> torch.optim.Adam:
    """Adam with optax's ``adam`` constants (betas 0.9/0.999, eps 1e-8).
    On a card it is capturable: its step counts live on the device and its
    bias correction is device arithmetic, so neither a step nor the NaN
    guard's select of its state (``train/engine.py``) reads the host."""
    params = list(params)
    on_card = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=on_card)


def init_adam_state_(opt: torch.optim.Adam) -> None:
    """Give every parameter the state Adam would create at its first step
    (step 0, zero moments), so the state exists before any step runs."""
    for group in opt.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=p.device if on_device else "cpu")
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def configure_optimizers(model: nn.Module, learning_rate: float = 1e-4,
                         aux_learning_rate: float = 1e-3,
                         clip_max_norm: float = 1.0
                         ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(main, aux) ``adam``s on disjoint parameter lists."""
    main_params, aux_params = split_parameters(model)
    main = adam(main_params, learning_rate)
    main.param_groups[0]["clip_max_norm"] = float(clip_max_norm or 0.0)
    return main, adam(aux_params, aux_learning_rate)


def clip_main_grads_(main: torch.optim.Optimizer) -> None:
    """Scale the main partition's gradients in place by
    ``min(1, max_norm / ||g||)``, ``||g||`` their global norm. On the
    device: no host read."""
    group = main.param_groups[0]
    max_norm = group.get("clip_max_norm", 0.0)
    grads = [p.grad for p in group["params"] if p.grad is not None]
    if not max_norm or not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:  # optax: select(keep, g, g / norm * max_norm)
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def get_main_lr(main: torch.optim.Optimizer) -> float:
    return float(main.param_groups[0]["lr"])


def set_main_lr(main: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Replace the main optimizer's learning rate (its moments stay)."""
    for group in main.param_groups:
        group["lr"] = float(lr)
    return main


@dataclasses.dataclass
class Plateau:
    """Learning-rate decay on a plateau of the eval loss."""
    patience: int
    floor: float
    best: float = float("inf")
    bad: int = 0

    def update(self, loss: float, lr: float) -> float | None:
        """Count an evaluation with ``loss``; the decayed learning rate
        where this one ends a plateau, else None."""
        if loss < self.best - 1e-6:
            self.best, self.bad = loss, 0
            return None
        self.bad += 1
        if self.bad <= self.patience:
            return None
        self.bad = 0
        return max(lr * 0.3, self.floor)
