"""What a training loop (``loops/train*.py``) shares: the benchmark's
batches and noise fed to the program's step, and the first steps that
the comparison follows."""

from __future__ import annotations

import torch

from . import traffic as T


class TrainFeed:
    """The benchmark's batches and noise, handed to the program's step
    through the model's ``draw_noise``."""

    def __init__(self, cfgmod, cfg, tr, photos, seed, device):
        self.cfgmod, self.cfg, self.tr = cfgmod, cfg, tr
        self.photos, self.seed, self.device = photos, seed, device
        self.gen = T.noise_generator(seed, device)
        self.current = None

    def batch(self, step: int):
        size = int(self.tr["crop"])
        x = self.photos.crops(T.crop_offsets(self.seed, step, self.tr, self.photos), size)
        shapes = self.cfgmod.noise_shapes(self.cfg, tuple(x.shape))
        self.current = T.train_noise(shapes, self.gen, self.device)
        return x, self.current

    def draw_noise(self, *args, **kwargs):
        return self.current


def checked_steps(state, step, feed, n: int):
    """The first ``n`` steps, through the window's own call and feed, with
    what the comparison needs: the weights before, each step's loss, the
    first step's gradients as the optimizers hold them (Adam's first
    moment over 1 - beta1) and the weights after."""
    named = list(state.model.named_parameters())
    before = {k: p.detach().clone() for k, p in named}
    losses, batches, grad1 = [], [], {}
    for i in range(n):
        x, noise = feed.batch(i)
        m = step(x, feed.gen, bool(feed.tr["noisequant"]))
        losses.append(m["loss"].detach().clone())
        batches.append((x, noise))
        if i == 0:
            for opt in (state.main, state.aux):
                beta1 = opt.param_groups[0]["betas"][0]
                ids = {id(p) for g in opt.param_groups for p in g["params"]}
                for k, p in named:
                    if id(p) in ids:  # no moment: the optimizer got no gradient
                        m = opt.state[p].get("exp_avg")
                        grad1[k] = torch.zeros_like(p) if m is None else m / (1 - beta1)
    after = {k: p.detach().clone() for k, p in named}
    return {"before": before, "after": after, "loss": losses, "grad1": grad1, "batches": batches}
