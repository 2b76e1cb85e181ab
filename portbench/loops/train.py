"""The recipe's training step, one after the other, with the batches and
noise drawn by the benchmark; the rate counts the images of the window's
steps.

Traffic keys: ``photo``, ``batch``, ``crop`` (the crops,
``lib/traffic.py``), ``noisequant``, ``lambda``, ``lr``, ``aux_lr``,
``clip`` (the recipe), ``checked_steps`` (the steps the comparison
follows, the run's first), ``warmup_steps`` and ``trace_steps`` (steps in
the profiled slice).
"""

from __future__ import annotations

import time

import torch

from portbench import counts
from portbench.lib import check
from portbench.lib.training import TrainFeed, checked_steps


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.cell.traffic
        self.next = 0  # the next step's number, which draws its batch

    def _step(self):
        x, _ = self.feed.batch(self.next)
        self.next += 1
        with self.ctx.spans("train.step"):
            self.step(x, self.feed.gen, bool(self.tr["noisequant"]))

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def setup(self):
        c = self.ctx
        cfg = c.cell.config
        self.state, step = c.cfgmod.training(cfg, c.root, c.device, c.W, self.tr, c.compute_dtype)
        self.feed = TrainFeed(c.cfgmod, cfg, self.tr, c.photos, c.seed, c.device)
        self.state.model.draw_noise = self.feed.draw_noise
        self.step = step if c.fault is None else c.fault(step, self.state)
        c.log(f"program built: {c.elapsed():.2f} s")
        n = int(self.tr["checked_steps"])
        self.checked = checked_steps(self.state, self.step, self.feed, n)
        self.next = n
        for _ in range(int(self.tr["warmup_steps"])):
            self._step()

    def window(self, seconds: float) -> dict:
        n = 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            self._step()
            n += 1
        self._sync()
        return {"window_s": time.perf_counter() - t_start, "steps": n,
                "images": n * int(self.tr["batch"]), "calls": {}}

    def slice(self):
        with self.ctx.spans("train"):
            for _ in range(int(self.tr["trace_steps"])):
                self._step()
            self._sync()

    def work(self, rec):
        c = self.ctx
        cfg, b, s = c.cell.config, int(self.tr["batch"]), int(self.tr["crop"])
        shapes = c.cfgmod.noise_shapes(cfg, (b, s, s, 3))
        rec["window_flops"] = rec["steps"] * counts.train_flops(cfg, c.refmod, c.W, self.tr, shapes)

    def release(self):
        del self.state, self.step, self.feed

    def check(self):
        c = self.ctx
        return check.train(c.cell, c.refmod, c.W, self.checked, c.cfgmod, c.device), 0
