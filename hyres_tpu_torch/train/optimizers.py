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
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


def is_quantile(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


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


def configure_optimizers(model: nn.Module, learning_rate: float = 1e-4,
                         aux_learning_rate: float = 1e-3,
                         clip_max_norm: float = 1.0
                         ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(main, aux) Adams on disjoint parameter lists (betas 0.9/0.999, eps
    1e-8, as optax's ``adam``)."""
    main_params, aux_params = split_parameters(model)
    main = torch.optim.Adam(main_params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    main.param_groups[0]["clip_max_norm"] = float(clip_max_norm or 0.0)
    aux = torch.optim.Adam(aux_params, lr=aux_learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return main, aux


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
