"""Checkpoint read and write in flax msgpack, without flax.

Counterpart of ``hyres_tpu/train/checkpoint.py:33-81``: thin wrappers over
``utils/flax_msgpack.py``. ``save_checkpoint`` writes what the reference's
does for the same tree (lists become maps keyed "0", "1", ...; every leaf
a numpy array; keys sorted), so either package reads the other's files.

A training checkpoint holds the reference's keys: ``epoch``, ``params``
(``{"params": tree}`` in the reference's flax layout, ``utils/convert.py
to_flax``, so the reference's ``restore_into`` takes it), ``main_state``
and ``aux_state`` (the port's Adam states, by parameter name: resume
within the port only), ``step``, ``loss`` and ``best_loss``.
``delete_by_prefix`` keeps one ``checkpoint_last_*`` and one
``checkpoint_best_*`` (rolling retention).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..utils import flax_msgpack
from ..utils.convert import from_flax, to_flax
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


def delete_by_prefix(directory, prefix: str) -> None:
    """Rolling retention: remove every file of ``directory`` whose name
    starts with ``prefix``."""
    d = Path(directory)
    if not d.is_dir():
        return
    for p in d.iterdir():
        if p.name.startswith(prefix):
            p.unlink()


def restore_into(model: nn.Module, raw: Dict[str, Any]) -> nn.Module:
    """Load the weights of any checkpoint flavour (either package's
    training checkpoint, an artifact, a bare params tree) into ``model``;
    every key must match."""
    model.load_state_dict(from_flax(extract_variables(raw)["params"]), strict=True)
    return model


def _optimizer_tree(opt: torch.optim.Optimizer, names: Dict[int, str]) -> dict:
    """An Adam state as arrays, keyed by parameter name, with its lr."""
    state = {}
    for group in opt.param_groups:
        for p in group["params"]:
            if p in opt.state:
                state[names[id(p)]] = {k: v.detach().cpu().numpy()
                                       for k, v in opt.state[p].items()}
    return {"lr": np.float64(opt.param_groups[0]["lr"]), "state": state}


def _load_optimizer_tree(opt: torch.optim.Optimizer, tree: dict,
                         names: Dict[int, str]) -> None:
    sd = opt.state_dict()
    saved = tree.get("state", {})
    index = 0
    for group in sd["param_groups"]:
        group["lr"] = float(tree["lr"])
    for group in opt.param_groups:
        for p in group["params"]:
            entry = saved.get(names[id(p)])
            if entry is not None:
                sd["state"][index] = {k: torch.from_numpy(np.array(v)) for k, v in entry.items()}
            index += 1
    opt.load_state_dict(sd)


def train_checkpoint(state, epoch: int, loss: float, best_loss: float) -> Dict[str, Any]:
    """A training state (``train/engine.py TrainState``) as the checkpoint
    tree ``save_checkpoint`` writes."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {"epoch": np.int64(epoch), "params": {"params": to_flax(state.model)},
            "main_state": _optimizer_tree(state.main, names),
            "aux_state": _optimizer_tree(state.aux, names),
            "step": np.int64(state.step), "loss": np.float64(loss),
            "best_loss": np.float64(best_loss)}


def restore_train_state(state, raw: Dict[str, Any]) -> None:
    """Resume ``state`` (weights, both optimizers, step) from a port
    training checkpoint."""
    restore_into(state.model, raw)
    names = {id(p): n for n, p in state.model.named_parameters()}
    _load_optimizer_tree(state.main, raw["main_state"], names)
    _load_optimizer_tree(state.aux, raw["aux_state"], names)
    state.step = int(raw["step"])
