"""Spatially tiled compression for very large images.

Counterpart of ``hyres_tpu/models/tiled.py``: the image is edge-padded to
a whole number of ``tile`` x ``tile`` tiles, the tiles go through the
codec as ONE batch (so the convolutions run batched and every tile gets
its own frames), and the decoded tiles are reassembled. Each tile is an
independent codec unit: decoding one needs only its own streams.
"""

from __future__ import annotations

from typing import Dict

import torch


def _grid(size: int, tile: int) -> int:
    return -(-size // tile)


def tiled_compress(codec, x: torch.Tensor, tile: int = 512) -> Dict:
    """x: (1, H, W, 3) -> the tile batch compressed in one codec call, with
    ``tile_grid`` (rows, columns, tile) and ``image_size`` (H, W) added."""
    assert x.shape[0] == 1, "tiled mode takes a single image"
    H, W = int(x.shape[1]), int(x.shape[2])
    th, tw = _grid(H, tile), _grid(W, tile)
    # edge padding: repeat the last row and column
    rows = torch.arange(th * tile, device=x.device).clamp_(max=H - 1)
    cols = torch.arange(tw * tile, device=x.device).clamp_(max=W - 1)
    xp = x[:, rows][:, :, cols]
    tiles = xp.reshape(1, th, tile, tw, tile, 3).permute(0, 1, 3, 2, 4, 5)
    comp = codec.compress(tiles.reshape(th * tw, tile, tile, 3))
    comp["tile_grid"] = (th, tw, tile)
    comp["image_size"] = (H, W)
    return comp


def tiled_decompress(codec, comp: Dict) -> Dict:
    """The tiles of ``tiled_compress`` -> {"x_hat" (1, H, W, 3), ...}."""
    th, tw, tile = comp["tile_grid"]
    H, W = comp["image_size"]
    if "jpeg_buffers" in comp:
        dec = codec.decompress(comp)
    else:
        dec = codec.decompress(comp["strings"], comp["shape"], comp.get("size"))
    tiles = dec["x_hat"].reshape(1, th, tw, tile, tile, 3).permute(0, 1, 3, 2, 4, 5)
    dec["x_hat"] = tiles.reshape(1, th * tile, tw * tile, 3)[:, :H, :W, :]
    return dec
