"""The one generator of every traffic mix: what a ``traffic/<name>.json``
file's parameters turn into, from ``--seed``.

Serving requests are windows cut from a mosaic of the photo's four flips
(twice its height and width): for each ``[h, w]`` of ``shapes``, the
windows at the points of a ``grid`` x ``grid`` lattice over the mosaic's
free room. Every seed sends the same windows, in an order of its own, so
that seeds change the order and not the work. Training batches are
``batch`` crops of ``crop`` x ``crop`` at offsets drawn from the seed, and
their noise draws U(-0.5, 0.5) on the device.
"""

from __future__ import annotations

import random

import torch

from .png import load_photo
from .spec import ROOT


class Photos:
    """The mosaic on the device, and windows of it."""

    def __init__(self, traffic: dict, device, root=ROOT):
        x = torch.tensor(load_photo(root / traffic["photo"]), device=device)
        top = torch.cat([x, x.flip(2)], dim=2)
        self.mosaic = torch.cat([top, top.flip(1)], dim=1).contiguous()

    def window(self, req):
        """The request ``(h, w, oy, ox)``'s image, (1, h, w, 3)."""
        h, w, oy, ox = req
        return self.mosaic[:, oy:oy + h, ox:ox + w].contiguous()

    def crops(self, offs, size: int):
        return torch.cat([self.mosaic[:, oy:oy + size, ox:ox + size] for oy, ox in offs])


def requests(traffic: dict, photos: Photos):
    """Every request of the mix, ``(h, w, oy, ox)``: each shape at each
    point of the lattice (points that coincide count once)."""
    n = int(traffic["grid"])
    out = []
    for h, w in traffic["shapes"]:
        H, W = photos.mosaic.shape[1] - int(h), photos.mosaic.shape[2] - int(w)
        if H < 0 or W < 0:
            raise ValueError(f"a {h}x{w} request does not fit the mosaic")
        d = max(n - 1, 1)
        pts = dict.fromkeys((round(i * H / d), round(j * W / d)) for i in range(n) for j in range(n))
        out += [(int(h), int(w), oy, ox) for oy, ox in pts]
    return out


def shapes(reqs) -> list:
    """The distinct (h, w) of some requests, in their first order."""
    return list(dict.fromkeys((r[0], r[1]) for r in reqs))


def request_order(seed: int, reqs):
    """The seed's order of the requests (a permutation, cycled by callers)."""
    order = list(reqs)
    random.Random(f"order:{seed}").shuffle(order)
    return order


def sampled(seed: int, i: int, every: int) -> bool:
    """Whether request ``i`` is among those checked: one in ``every``, at a
    phase drawn from the seed."""
    return i % every == random.Random(f"sample:{seed}").randrange(every)


def crop_offsets(seed: int, step: int, traffic: dict, photos: Photos):
    """``batch`` distinct crop offsets of training step ``step``."""
    r = random.Random(f"crops:{seed}:{step}")
    size = int(traffic["crop"])
    H, W = photos.mosaic.shape[1] - size, photos.mosaic.shape[2] - size
    offs = set()
    while len(offs) < int(traffic["batch"]):
        offs.add((r.randrange(H + 1), r.randrange(W + 1)))
    return sorted(offs)


def noise_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def train_noise(shapes: dict, gen: torch.Generator, device) -> dict:
    """U(-0.5, 0.5) draws of the given shapes, in the given order."""
    return {k: torch.rand(s, generator=gen, device=device, dtype=torch.float32) - 0.5
            for k, s in shapes.items()}
