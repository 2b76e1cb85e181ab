"""Batch-sharded evaluation over a data-parallel group.

Counterpart of ``hyres_tpu/parallel/inference.py``: a batch of images is
evaluated with its rows sharded over the ranks (``mesh.py``), and the
per-image results are gathered to every rank in batch order with one
collective. The forward runs under ``train/engine.py train_numerics``,
as ``make_eval_step``'s does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch import nn

from ..train.engine import train_numerics
from .mesh import DataParallel


def make_sharded_eval(model: nn.Module, dp: DataParallel) -> Callable:
    """eval_fn(batch) -> {"x_hat", "psnr", "bpp_est"} for an NHWC batch in
    [0, 1]: ``x_hat`` clipped to [0, 1], per-image ``psnr`` and
    ``bpp_est`` (likelihood bits over the pixel count, plus the model's
    ``jpeg_bpp_loss`` where it has one: as in JAX, that term is the
    global batch's mean). Real byte counts come from the codecs."""

    @torch.no_grad()
    def eval_fn(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, H, W, C = batch.shape
        lo, hi = dp.rows(B)
        local = batch[lo:hi].to(dp.device, torch.float32)
        # a row: x_hat, psnr, the likelihood bpp, the local mean JPEG bpp
        rows = torch.zeros(dp.rows(B, 0)[1], H * W * C + 3, device=dp.device)
        if hi > lo:
            model.eval()
            with train_numerics(dp.device):
                out = model(local, noisequant=False)
            x_hat = torch.clamp(out["x_hat"], 0.0, 1.0)
            mse = torch.mean((x_hat - local) ** 2, dim=(1, 2, 3))
            bpp = sum(-torch.sum(torch.log2(l), dim=(1, 2, 3)) / (H * W)
                      for l in out["likelihoods"].values())
            rows[:hi - lo, :-3] = x_hat.reshape(hi - lo, -1)
            rows[:hi - lo, -3] = -10.0 * torch.log10(mse)
            rows[:hi - lo, -2] = bpp
            rows[:hi - lo, -1] = out.get("jpeg_bpp_loss", 0.0)
        if dp.group is not None:
            parts = [torch.empty_like(rows) for _ in range(dp.world)]
            dist.all_gather(parts, rows, group=dp.group)
            counts = [b - a for a, b in (dp.rows(B, r) for r in range(dp.world))]
            rows = torch.cat([p[:n] for p, n in zip(parts, counts)])
        rows = rows[:B]
        return {"x_hat": rows[:, :-3].reshape(B, H, W, C), "psnr": rows[:, -3],
                "bpp_est": rows[:, -2] + rows[:, -1].mean()}

    return eval_fn
