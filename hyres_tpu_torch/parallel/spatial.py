"""One image's rows sharded over a data-parallel group, with halos.

Counterpart of ``hyres_tpu/parallel/spatial.py``: each rank evaluates a
horizontal strip extended by a halo that covers the receptive field,
crops its valid rows, and the strips gather back into the full
reconstruction. ``strip_forward`` is the per-strip function, so one
process can also run every strip in turn.

CONTRACT (JAX's, word for word): this is a RECONSTRUCTION-SERVING path,
not a codec path — strips do not produce (or consume) the single-image
bitstream, and the returned bits are telemetry (valid-row likelihood
bits), not a byte count. The output approximates the unsharded eval
forward: the conv transforms are exact given the halo, but each strip
quantizes its latents against ITS OWN entropy-model estimates, whose
receptive field near strip boundaries differs from the full image's, so
individual latent roundings may flip within ~halo of a boundary.
Guarantee tested: interior rows bit-match a haloed single-strip forward;
the full image differs from the unsharded forward by <1e-3 mean abs err
with flips confined to boundary bands.

Coding (compress/decompress) over strips is the tiled path
(``models/tiled.py``) — strips there are independent codec units.

The forward runs under the process's cuDNN flags (on the card the coder
path's deterministic ones, ``utils/device.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import DataParallel


def _strip_rows(H: int, n: int, halo: int) -> int:
    if H % (64 * n) or halo % 64:
        raise ValueError(f"{n} strips of an image of {H} rows with a halo of {halo}: "
                         "the strip and the halo must be multiples of 64 rows")
    strip = H // n
    if strip + 2 * halo > H:
        raise ValueError(f"a strip of {strip} rows with a halo of {halo} on each side "
                         f"needs {strip + 2 * halo} rows, and the image has {H}: use "
                         "fewer strips or a smaller halo")
    return strip


@torch.no_grad()
def strip_forward(model: nn.Module, x: torch.Tensor, i: int, n: int,
                  halo: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strip ``i`` of ``n`` of NHWC ``x`` (B, H, W, 3): the eval forward of
    its rows plus ``halo`` on each side (clamped, so a boundary strip
    slides inward and the image edge stays the true edge), cropped to the
    strip -> (x_hat rows, likelihood bits of the strip's valid latent rows)."""
    H = x.shape[1]
    strip = _strip_rows(H, n, halo)
    tile_h = strip + 2 * halo
    start = min(max(i * strip - halo, 0), H - tile_h)
    model.eval()
    out = model(x[:, start:start + tile_h], noisequant=False)
    off = i * strip - start
    bits = torch.zeros((), device=x.device)
    for lik in out["likelihoods"].values():
        # halo rows are evaluated on two or three strips: count only the
        # valid ones (off and strip are multiples of every latent stride)
        stride = tile_h // lik.shape[1]
        bits = bits - torch.sum(torch.log2(lik[:, off // stride:(off + strip) // stride]))
    return out["x_hat"][:, off:off + strip], bits


def make_spatial_eval(model: nn.Module, dp: DataParallel, halo: int = 64) -> Callable:
    """eval_fn(x) -> (x_hat, bits) for one NHWC image: rank r runs strip r
    of ``dp.world``; the strips are all-gathered into ``x_hat`` and the
    bits summed over the ranks, in one collective."""

    def eval_fn(x: torch.Tensor):
        x = x.to(dp.device, torch.float32)
        x_hat, bits = strip_forward(model, x, dp.rank, dp.world, halo)
        if dp.group is None:
            return x_hat, bits
        mine = torch.cat([x_hat.float().reshape(-1), bits.reshape(1)])
        parts = [torch.empty_like(mine) for _ in range(dp.world)]
        dist.all_gather(parts, mine, group=dp.group)
        strips = [p[:-1].view_as(x_hat) for p in parts]
        return torch.cat(strips, dim=1), torch.stack([p[-1] for p in parts]).sum()

    return eval_fn
