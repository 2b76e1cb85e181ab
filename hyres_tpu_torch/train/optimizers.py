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

``FlatAdam`` keeps one Adam's leaves in contiguous buffers, so that the
training step's tail (``train/engine.py``: the NaN guard, the clip, the
Adam step and the select) runs as a few launches over whole buffers, not
a few per leaf. Bound at a step, it makes each parameter's ``.data``, its
``.grad`` and its ``exp_avg``/``exp_avg_sq`` views of the buffers, and
every leaf's ``step`` one shared scalar; the Adam itself is unchanged and
still holds the views. ``bind_flat`` binds anew only when those tensors
were replaced (a restored optimizer state, moved parameters). Counts in
``OPTIM_STATS``.

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


OPTIM_STATS = {"binds": 0, "flat_steps": 0, "leaves": {}}
"""``binds``: flat bindings made (``bind_flat``); ``flat_steps``: training
steps whose optimizer tail ran on flat buffers; ``leaves``: the leaves of
each partition at its latest binding."""

_ALIGN = 64  # elements: a float32 leaf's view starts on 256 bytes, as its own allocation
# would, so that the model's kernels keep their aligned vector loads


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _Chunk:
    """Leaves of one param group with one dtype, device and step count: a
    gradient buffer and a state buffer ``[params | exp_avg | exp_avg_sq |
    step]``, each role one run of the leaves at aligned offsets. The gaps
    stay zero: zero gradients leave zero moments and parameters as they
    are. ``step`` sits in the buffer where it shares its device and dtype
    (capturable, float32), else beside it; ``live`` is what a snapshot of
    the chunk copies. The Adam step runs through a private Adam over the
    one flat parameter, with the group's hyperparameters, so that each
    element gets the arithmetic the per-leaf step gives it."""

    def __init__(self, group: dict, params: list, state, roles: tuple):
        p0, n = params[0], len(roles) + 1
        dtype, device = p0.dtype, p0.device
        sizes = [_padded(p.numel()) for p in params]
        total = sum(sizes)
        step = state[p0]["step"]
        inline = step.device == device and step.dtype == dtype
        self.group = group
        self.grad = torch.zeros(total, dtype=dtype, device=device)
        self.slab = torch.zeros(n * total + inline, dtype=dtype, device=device)
        self.step = self.slab[-1] if inline else torch.empty_like(step)
        self.live = [self.slab] if inline else [self.slab, self.step]
        runs = [self.slab[i * total:(i + 1) * total] for i in range(n)]
        self.param = runs[0]
        dst, src, o = [], [], 0
        for p, size in zip(params, sizes):
            views = [r[o:o + p.numel()].view_as(p) for r in runs]
            dst += views
            src += [p.detach()] + [state[p][k] for k in roles]
            p.data = views[0]
            p.grad = self.grad[o:o + p.numel()].view_as(p)
            state[p].update(zip(roles, views[1:]), step=self.step)
            o += size
        with torch.no_grad():
            self.step.copy_(step)
            torch._foreach_copy_(dst, src)
        self.param.grad = self.grad
        self.adam = torch.optim.Adam([self.param])
        self.adam.state[self.param] = {"step": self.step,
                                       **{k: r for k, r in zip(roles, runs[1:])}}

    def step_(self) -> None:
        hyper = self.adam.param_groups[0]
        hyper.update((k, v) for k, v in self.group.items() if k != "params")
        self.adam.step()


def _unshare_steps(opt, args, kwargs) -> None:
    """A per-leaf ``opt.step()`` would count a shared step once a leaf:
    each leaf takes its own copy first, and the next flat step binds anew."""
    for st in opt.state.values():
        if "step" in st:
            st["step"] = st["step"].clone()


class FlatAdam:
    """One Adam's leaves in flat buffers (see the module's docstring):
    ``grads`` and ``values`` the gradient and parameter buffers, ``live``
    every tensor the step changes (what a snapshot copies). Binding creates
    the state Adam's first step would (``init_adam_state_``) and copies
    every parameter and state value into the buffers, so seeded or
    restored moments and step counts carry over."""

    def __init__(self, opt: torch.optim.Adam):
        init_adam_state_(opt)
        self.opt = opt
        self.params = [p for g in opt.param_groups for p in g["params"]]
        roles = tuple(k for k in opt.state[self.params[0]] if k != "step") if self.params else ()
        self.chunks = []
        for group in opt.param_groups:
            if not group["params"]:
                continue
            steps = torch.stack([opt.state[p]["step"] for p in group["params"]]).tolist()
            by_key: dict = {}
            for p, s in zip(group["params"], steps):
                by_key.setdefault((p.dtype, p.device, s), []).append(p)
            self.chunks += [_Chunk(group, ps, opt.state, roles) for ps in by_key.values()]
        self.grads = [c.grad for c in self.chunks]
        self.values = [c.param for c in self.chunks]
        self.live = [t for c in self.chunks for t in c.live]
        self._ptrs = [p.data_ptr() for p in self.params]
        self._grads = [p.grad for p in self.params]
        self._state = self._state_tensors(self.params)
        self._hook = opt.register_step_pre_hook(_unshare_steps)

    def _state_tensors(self, params) -> list:
        return [t for p in params for t in self.opt.state[p].values()]

    def bound(self) -> bool:
        """The optimizer's leaves, their data and their state are still the
        tensors bound (a restore or a move replaces them)."""
        params = [p for g in self.opt.param_groups for p in g["params"]]
        if len(params) != len(self.params) or any(a is not b for a, b in zip(params, self.params)):
            return False
        state = self._state_tensors(params)
        return ([p.data_ptr() for p in params] == self._ptrs and len(state) == len(self._state)
                and all(a is b for a, b in zip(state, self._state)))

    def release(self) -> None:
        """Drop the step hook: a new binding of the optimizer takes over."""
        self._hook.remove()

    def zero_grad_(self) -> None:
        """Zero the gradient buffers; every leaf's ``.grad`` is its view
        again (autograd adds into the views in place)."""
        for g in self.grads:
            g.zero_()
        for p, g in zip(self.params, self._grads):
            if p.grad is not g:
                p.grad = g

    def clip_(self) -> None:
        """Scale the gradients in place by ``min(1, max_norm / ||g||)``,
        ``||g||`` their global norm, ``max_norm`` the first group's
        ``clip_max_norm`` (0 or none: no clip). On the device: no host read."""
        max_norm = self.opt.param_groups[0].get("clip_max_norm", 0.0)
        if not max_norm or not self.grads:
            return
        norms = [torch.linalg.vector_norm(g) for g in self.grads]
        norm = norms[0] if len(norms) == 1 else torch.linalg.vector_norm(torch.stack(norms))
        keep = norm < max_norm
        for g in self.grads:  # optax: select(keep, g, g / norm * max_norm)
            torch.where(keep, g, g / norm * max_norm, out=g)

    def step_(self) -> None:
        """The Adam step on the buffers."""
        for c in self.chunks:
            c.step_()


def bind_flat(opts: dict, flats: list | None = None) -> list:
    """[``FlatAdam``] of the optimizers ``opts`` ({partition name: Adam}):
    ``flats`` while they are all still bound, else a new binding."""
    if flats is not None and all(f.bound() for f in flats):
        return flats
    for f in flats or ():
        f.release()
    flats = [FlatAdam(opt) for opt in opts.values()]
    OPTIM_STATS["binds"] += 1
    for name, f in zip(opts, flats):
        OPTIM_STATS["leaves"][name] = len(f.params)
    return flats


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
