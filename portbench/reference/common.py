"""What the reference of every configuration shares: weight layouts, the
checkerboard decode order, comparisons, and the training recipe (the RD
loss's Adam steps) in plain PyTorch. Imports nothing of the program."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import nets as R

ANCHOR, NON_ANCHOR = 0, 1


@contextlib.contextmanager
def float32_numerics(autotuned: bool = False):
    """Full float32 in convolutions and matrix products for the scope (no
    TF32, whatever the process's defaults), restored after. cuDNN picks
    deterministic algorithms, or with ``autotuned`` benchmarks its float32
    algorithms as a training recipe does."""
    m = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=autotuned,
                                        deterministic=not autotuned, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m


def flax_to_torch(tree: dict, prefix: str = "") -> dict:
    """A flax parameter tree -> {dotted name: numpy array} in PyTorch
    layouts: conv kernels HWIO -> OIHW; kernels under a ``Deconv_*``
    module (an input-dilated correlation) flipped in space and laid out
    (I, O, kH, kW) for ``conv_transpose2d``; dense kernels transposed;
    everything else as stored."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            name = k
            if k == "kernel":
                name = "weight"
                if a.ndim == 2:
                    a = a.T
                elif path and path[-1].startswith("Deconv_"):
                    a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
                else:
                    a = np.transpose(a, (3, 2, 0, 1))
            out[prefix + ".".join(path + (name,))] = np.array(a, np.float32, order="C")

    walk(tree, ())
    return out


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def pad_to(x, mult: int):
    """Edge-pad NHWC H and W up to multiples of ``mult``."""
    ph, pw = (-x.shape[1]) % mult, (-x.shape[2]) % mult
    if not (ph or pw):
        return x
    return nhwc(torch.nn.functional.pad(nchw(x), (0, pw, 0, ph), mode="replicate"))


def mismatch_share(a, b) -> float:
    """Share of elements where two symbol planes differ (1.0 if their
    shapes differ)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return 1.0
    return float((a != b).sum()) / max(a.numel(), 1)


def rmse(a, b) -> float:
    a = a.to(torch.float64)
    return float(torch.sqrt(torch.mean((a - b.to(a.device, torch.float64)) ** 2)))


# -- training: the recipe's two Adams ------------------------------------------------------

BETAS, EPS = (0.9, 0.999), 1e-8


def is_aux(name: str) -> bool:
    return name.endswith("quantiles")


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction, on a dict of leaves."""

    def __init__(self, names, lr):
        self.names, self.lr, self.t, self.m, self.v = list(names), lr, 0, {}, {}

    def step(self, W, grads):
        self.t += 1
        b1, b2 = BETAS
        for n in self.names:
            g = grads[n]
            self.m[n] = b1 * self.m.get(n, torch.zeros_like(g)) + (1 - b1) * g
            self.v[n] = b2 * self.v.get(n, torch.zeros_like(g)) + (1 - b2) * g * g
            mh = self.m[n] / (1 - b1 ** self.t)
            vh = self.v[n] / (1 - b2 ** self.t)
            with torch.no_grad():
                W[n] -= self.lr * mh / (torch.sqrt(vh) + EPS)


def train_steps(W, loss_fn, batches, noises, recipe):
    """The recipe's steps from weights ``W`` (leaves that require grad, moved
    in place): per step the RD loss's gradients of the main leaves, their
    global norm clipped to ``clip``, the main Adam step, then the aux loss
    (the prior's quantile fit) at the updated weights and the aux Adam step.
    A step whose gradients are not all finite moves nothing. Returns
    ``{"loss": [per step], "grad1": {leaf: norm of the first step's clipped
    gradient}, "aux_grad1": ..., "W": W}``."""
    main_names = [n for n in W if not is_aux(n)]
    aux_names = [n for n in W if is_aux(n)]
    main, aux = Adam(main_names, recipe["lr"]), Adam(aux_names, recipe["aux_lr"])
    losses, grad1 = [], {}
    for i, (x, noise) in enumerate(zip(batches, noises)):
        loss = loss_fn(W, x, noise)
        gs = torch.autograd.grad(loss, [W[n] for n in main_names], allow_unused=True)
        grads = {n: torch.zeros_like(W[n]) if g is None else g for n, g in zip(main_names, gs)}
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
        if recipe["clip"] and norm >= recipe["clip"]:
            grads = {n: g * (recipe["clip"] / norm) for n, g in grads.items()}
        if finite:
            main.step(W, grads)
        aux_loss = R.eb_aux_loss(W)
        ag = dict(zip(aux_names, torch.autograd.grad(aux_loss, [W[n] for n in aux_names])))
        if finite:
            aux.step(W, ag)
        if i == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g.double())) for n, g in
                     {**grads, **ag}.items()}
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad1": grad1, "W": W}
