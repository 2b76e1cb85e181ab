"""flax parameter trees <-> PyTorch state dicts.

The port's modules carry the reference's flax names (``nn/layers.py``),
so a flax path maps to a state-dict key by joining it with dots; only
the leaves change layout:

  conv ``kernel`` (HWIO)           -> ``weight`` (OIHW)
  ``Deconv_*`` ``kernel`` (HWIO of an input-dilated correlation)
                                   -> ``weight`` (I, O, kH, kW) for
                                      ``conv_transpose2d``: spatially
                                      flipped, as ``hyres_tpu/utils/
                                      torch_convert.py:36-50`` maps the
                                      other way
  dense ``kernel`` (in, out)       -> ``weight`` (out, in)
  GDN ``beta``/``gamma``, PReLU ``alpha``, entropy-bottleneck
  parameters, biases               -> as stored

``to_flax`` is the exact inverse, so the port writes ``params`` in the
reference's tree layout and either package reads the other's weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _leaf(path: tuple, value: np.ndarray) -> tuple:
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name != "kernel":
        return name, np.asarray(value)
    w = np.asarray(value)
    if w.ndim == 2:  # dense
        return "weight", w.T
    if parent.startswith("Deconv_"):
        return "weight", np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
    return "weight", np.transpose(w, (3, 2, 0, 1))


def from_flax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree -> a state dict for the port's modules."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            name, arr = _leaf(path + (k,), v)
            key = ".".join(path + (name,))
            out[prefix + key] = torch.from_numpy(np.array(arr, np.float32))

    walk(tree, ())
    return out


def load_state_dict(model: nn.Module, params: dict) -> None:
    """Load a flax params tree into ``model`` (every key must match)."""
    model.load_state_dict(from_flax(params), strict=True)


def _unleaf(path: tuple, name: str, value: np.ndarray) -> tuple:
    if name != "weight":
        return name, value
    parent = path[-1] if path else ""
    if value.ndim == 2:  # dense
        return "kernel", value.T
    if parent.startswith("Deconv_"):
        return "kernel", np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
    return "kernel", np.transpose(value, (2, 3, 1, 0))


def to_flax(state: Dict[str, torch.Tensor] | nn.Module) -> dict:
    """A state dict (or a module's) -> a flax ``params`` tree of float32
    numpy arrays, the inverse of ``from_flax``."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for key, t in state.items():
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        leaf, arr = _unleaf(tuple(path), name, t.detach().cpu().numpy())
        node[leaf] = np.array(arr, np.float32, order="C")
    return tree
