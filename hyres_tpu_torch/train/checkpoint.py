"""Checkpoint read and write in flax msgpack, without flax.

Counterpart of ``hyres_tpu/train/checkpoint.py:33-81``: thin wrappers over
``utils/flax_msgpack.py``. ``save_checkpoint`` writes what the reference's
does for the same tree (lists become maps keyed "0", "1", ...; every leaf
a numpy array; keys sorted), so either package reads the other's files.
The training-state restore and the rolling retention wait for the
training slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..utils import flax_msgpack
from ..utils.flax_msgpack import load_checkpoint  # noqa: F401  (the reference's name)


def _state_dict(node):
    """The tree as flax's ``to_state_dict`` and ``np.asarray`` leave it:
    maps with string keys, lists and tuples as maps keyed by position,
    tensors and Python scalars as numpy arrays, None kept."""
    if isinstance(node, dict):
        return {str(k): _state_dict(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(node)}
    if node is None:
        return None
    if hasattr(node, "detach"):
        node = node.detach().cpu().numpy()
    return np.asarray(node)


def save_checkpoint(state_dict: Dict[str, Any], path) -> None:
    """Write a tree of arrays as a flax msgpack checkpoint (atomically)."""
    flax_msgpack.save_checkpoint(_state_dict(state_dict), path)


def unwrap_params(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Unwrap the {network|state_dict|params|raw} checkpoint formats."""
    for key in ("network", "state_dict", "params"):
        if isinstance(raw, dict) and key in raw:
            return raw[key]
    return raw


def extract_variables(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Any checkpoint flavour -> a variables dict {"params": tree}."""
    v = unwrap_params(raw)
    if isinstance(v, dict) and set(v.keys()) == {"params"}:
        return v
    return {"params": v}
