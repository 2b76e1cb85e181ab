"""Reference ``.pth`` checkpoints <-> flax-layout parameter trees.

Counterpart of ``hyres_tpu/utils/torch_convert.py``, kept as the port's
own copy. The reference stores CompressAI-named state dicts (HyRES routes
``residual_model.*`` and ``refine.*``; the checkerboard codec carries
entropy-coder buffers of variable size). The converters here turn them
into the trees the JAX package's flax modules take, leaf for leaf, and
that tree is the port's interchange format: ``utils/convert.py
from_flax`` / ``load_state_dict`` load it into the port's modules, whose
names are flax's. So a reference checkpoint loads as

    load_state_dict(model, convert_hyres(load_pth(path))["params"])

Leaf layouts:
  conv:            torch (O, I, kH, kW)  -> HWIO (kH, kW, I, O)
  conv-transpose:  torch (I, O, kH, kW)  -> HWIO + spatial flip (flax's
                   Deconv is an input-dilated correlation; ``from_flax``
                   flips it back for ``conv_transpose2d``)
  linear:          torch (O, I)          -> (I, O)
  GDN beta/gamma, bottleneck matrices/biases/factors/quantiles: the
  stored (CompressAI-reparameterized) values, copied.
Entropy-coder buffers (``_quantized_cdf``, ``_offset``, ``_cdf_length``,
``scale_table``) are dropped: the codec re-bakes its tables from the
learned density with ``update()``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

Array = np.ndarray
TorchSD = Dict[str, Array]
Tree = Dict


def _t2j_conv(w: Array) -> Array:
    return np.transpose(w, (2, 3, 1, 0))


def _t2j_deconv(w: Array) -> Array:
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()


def _j2t_conv(w: Array) -> Array:
    return np.transpose(w, (3, 2, 0, 1))


def _j2t_deconv(w: Array) -> Array:
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1)).copy()


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def _subtree(sd: TorchSD, prefix: str) -> TorchSD:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _set(tree: Tree, path: Sequence[str], value: Array):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


# -- leaf kinds: a torch subtree -> a flax subtree ----------------------------


def _conv_leaf(sub: TorchSD, wrapped: bool = True) -> Tree:
    out: Tree = {}
    k = _t2j_conv(sub["weight"])
    if wrapped:  # the Conv module wraps a flax nn.Conv: a Conv_0 scope
        out["Conv_0"] = {"kernel": k}
        if "bias" in sub:
            out["Conv_0"]["bias"] = np.asarray(sub["bias"])
    else:
        out["kernel"] = k
        if "bias" in sub:
            out["bias"] = np.asarray(sub["bias"])
    return out


def _deconv_leaf(sub: TorchSD) -> Tree:
    out: Tree = {"kernel": _t2j_deconv(sub["weight"])}
    if "bias" in sub:
        out["bias"] = np.asarray(sub["bias"])
    return out


def _gdn_leaf(sub: TorchSD) -> Tree:
    return {"beta": np.asarray(sub["beta"]),
            "gamma": np.asarray(sub["gamma"]).reshape(
                sub["beta"].shape[0], sub["beta"].shape[0])}


def _ordered_convs(sub: TorchSD) -> List[Tuple[Array, Array | None]]:
    """Every 4-D conv (weight, bias) pair of a torch subtree in natural
    key order, which is ``nn.Sequential``'s definition order."""
    out = []
    for k in sorted(sub, key=_natural_key):
        if k.endswith("weight") and sub[k].ndim == 4:
            bkey = k[: -len("weight")] + "bias"
            out.append((sub[k], sub.get(bkey)))
    return out


def _fill_convs(paths: List[Sequence[str]], sub: TorchSD) -> Tree:
    convs = _ordered_convs(sub)
    if len(convs) != len(paths):
        raise ValueError(f"conv count mismatch: torch has {len(convs)}, "
                         f"flax expects {len(paths)}")
    tree: Tree = {}
    for path, (w, b) in zip(paths, convs):
        _set(tree, list(path) + ["kernel"], _t2j_conv(w))
        if b is not None:
            _set(tree, list(path) + ["bias"], b)
    return tree


def _rbb_leaf(sub: TorchSD) -> Tree:
    # 1x1 -> 3x3 -> 1x1, each a wrapped Conv
    return _fill_convs([(f"Conv_{i}", "Conv_0") for i in range(3)], sub)


def _attention_leaf(sub: TorchSD) -> Tree:
    # trunk units 0-2, gate units 3-5 (three convs each), then the final
    # 1x1. The torch keys sort as conv_a.0..2 < conv_b.0..2 < conv_b.3,
    # which is the flax definition order.
    paths: List[Tuple[str, ...]] = []
    for ru in range(6):
        for c in range(3):
            paths.append((f"_ResidualUnit_{ru}", f"Conv_{c}", "Conv_0"))
    paths.append(("Conv_0", "Conv_0"))
    return _fill_convs(paths, sub)


def _entropy_bottleneck_leaf(sub: TorchSD, n_filters: int = 4) -> Tree:
    out: Tree = {"quantiles": np.asarray(sub["quantiles"])}
    for k in range(n_filters + 1):
        out[f"matrix_{k}"] = np.asarray(sub[f"_matrices.{k}"])
        out[f"bias_{k}"] = np.asarray(sub[f"_biases.{k}"])
        if k < n_filters:
            out[f"factor_{k}"] = np.asarray(sub[f"_factors.{k}"])
    return out


# -- the checkerboard codec's transforms --------------------------------------

_GA_LAYERS = [("0", "Conv_0", "conv"), ("1", "GDN_0", "gdn"),
              ("2", "ResidualBottleneckBlock_0", "rbb"),
              ("3", "AttentionBlock_0", "attn"), ("4", "Conv_1", "conv"),
              ("5", "GDN_1", "gdn"), ("6", "ResidualBottleneckBlock_1", "rbb"),
              ("7", "Conv_2", "conv"), ("8", "AttentionBlock_1", "attn")]

_GS_LAYERS = [("0", "AttentionBlock_0", "attn"), ("1", "Deconv_0", "deconv"),
              ("2", "ResidualBottleneckBlock_0", "rbb"), ("3", "GDN_0", "gdn"),
              ("4", "Deconv_1", "deconv"), ("5", "AttentionBlock_1", "attn"),
              ("6", "ResidualBottleneckBlock_1", "rbb"), ("7", "GDN_1", "gdn"),
              ("8", "Deconv_2", "deconv")]

_HA_LAYERS = [("0", "Conv_0", "conv"), ("2", "Conv_1", "conv"),
              ("4", "Conv_2", "conv")]

_HS_LAYERS = [("0", "Deconv_0", "deconv"), ("2", "Deconv_1", "deconv"),
              ("4", "Conv_0", "conv")]

_PA_LAYERS = [("0", "Conv_0", "conv"), ("2", "Conv_1", "conv"),
              ("4", "Conv_2", "conv")]

_KIND_FNS = {"conv": _conv_leaf, "gdn": _gdn_leaf, "rbb": _rbb_leaf,
             "attn": _attention_leaf, "deconv": _deconv_leaf}


def _convert_sequential(sub: TorchSD, layers) -> Tree:
    return {flax_name: _KIND_FNS[kind](_subtree(sub, torch_idx))
            for torch_idx, flax_name, kind in layers}


def _masked_conv_leaf(sub: TorchSD) -> Tree:
    """CheckboardMaskedConv: plain conv layout; the mask buffer is dropped."""
    out: Tree = {"kernel": _t2j_conv(sub["weight"])}
    if "bias" in sub:
        out["bias"] = np.asarray(sub["bias"])
    return out


def convert_checkerboard(sd: TorchSD) -> Tree:
    """A LightWeightCheckerboard state dict -> its flax params subtree."""
    return {
        "g_a": _convert_sequential(_subtree(sd, "g_a"), _GA_LAYERS),
        "g_s": _convert_sequential(_subtree(sd, "g_s"), _GS_LAYERS),
        "h_a": _convert_sequential(_subtree(sd, "h_a"), _HA_LAYERS),
        "h_s": _convert_sequential(_subtree(sd, "h_s"), _HS_LAYERS),
        "param_aggregation": _convert_sequential(
            _subtree(sd, "param_aggregation"), _PA_LAYERS),
        "context_prediction": _masked_conv_leaf(_subtree(sd, "context_prediction")),
        "entropy_bottleneck": _entropy_bottleneck_leaf(
            _subtree(sd, "entropy_bottleneck")),
    }


# -- LightWeightELIC -----------------------------------------------------------

_CC_LAYERS = [("0", "Conv_0", "conv"), ("2", "Conv_1", "conv"),
              ("4", "Conv_2", "conv")]


def convert_elic(sd: TorchSD, num_slices: int = 5) -> Tree:
    """A LightWeightELIC state dict -> its flax params subtree.

    Per slice: ``cc_transforms.{i}`` (three stride-1 convs at 0/2/4),
    ``context_prediction.{i}`` (masked conv) and ``ParamAggregation.{i}``
    (three 1x1 convs at 0/2/4), under the reference's capitalised name.
    """
    out: Tree = {
        "g_a": _convert_sequential(_subtree(sd, "g_a"), _GA_LAYERS),
        "g_s": _convert_sequential(_subtree(sd, "g_s"), _GS_LAYERS),
        "h_a": _convert_sequential(_subtree(sd, "h_a"), _HA_LAYERS),
        "h_s": _convert_sequential(_subtree(sd, "h_s"), _HS_LAYERS),
        "entropy_bottleneck": _entropy_bottleneck_leaf(
            _subtree(sd, "entropy_bottleneck")),
    }
    for i in range(num_slices - 1):
        out[f"cc_transforms_{i}"] = _convert_sequential(
            _subtree(sd, f"cc_transforms.{i}"), _CC_LAYERS)
    for i in range(num_slices):
        out[f"context_prediction_{i}"] = _masked_conv_leaf(
            _subtree(sd, f"context_prediction.{i}"))
        out[f"param_aggregation_{i}"] = _convert_sequential(
            _subtree(sd, f"ParamAggregation.{i}"), _PA_LAYERS)
    return out


# -- Cheng2020withCheckerboard (CompressAI's Cheng2020Anchor topology) ---------


def _wrapped_conv(sub: TorchSD, name: str) -> Tree:
    return {"Conv_0": {"kernel": _t2j_conv(sub[f"{name}.weight"]),
                       "bias": np.asarray(sub[f"{name}.bias"])}}


def _rb_leaf(sub: TorchSD) -> Tree:
    """ResidualBlock: conv1, conv2 and the optional 1x1 skip."""
    out: Tree = {"Conv_0": _wrapped_conv(sub, "conv1"),
                 "Conv_1": _wrapped_conv(sub, "conv2")}
    if "skip.weight" in sub:
        out["Conv_2"] = _wrapped_conv(sub, "skip")
    return out


def _rbs_leaf(sub: TorchSD) -> Tree:
    """ResidualBlockWithStride: conv1, conv2, gdn and the skip."""
    out = _rb_leaf(sub)
    out["GDN_0"] = _gdn_leaf(_subtree(sub, "gdn"))
    return out


def _subpel_leaf(sub: TorchSD) -> Tree:
    """subpel_conv3x3 = Sequential(conv3x3, PixelShuffle): key ``0.weight``."""
    return {"Conv_0": _wrapped_conv(sub, "0")}


def _rbu_leaf(sub: TorchSD) -> Tree:
    return {"SubpelConv3x3_0": _subpel_leaf(_subtree(sub, "subpel_conv")),
            "Conv_0": _wrapped_conv(sub, "conv"),
            "GDN_0": _gdn_leaf(_subtree(sub, "igdn")),
            "SubpelConv3x3_1": _subpel_leaf(_subtree(sub, "upsample"))}


_CHENG_GA = [("0", "ResidualBlockWithStride_0", _rbs_leaf),
             ("1", "ResidualBlock_0", _rb_leaf),
             ("2", "ResidualBlockWithStride_1", _rbs_leaf),
             ("3", "ResidualBlock_1", _rb_leaf),
             ("4", "ResidualBlockWithStride_2", _rbs_leaf),
             ("5", "ResidualBlock_2", _rb_leaf),
             ("6", "Conv_0", _conv_leaf)]

_CHENG_GS = [("0", "ResidualBlock_0", _rb_leaf),
             ("1", "ResidualBlockUpsample_0", _rbu_leaf),
             ("2", "ResidualBlock_1", _rb_leaf),
             ("3", "ResidualBlockUpsample_1", _rbu_leaf),
             ("4", "ResidualBlock_2", _rb_leaf),
             ("5", "ResidualBlockUpsample_2", _rbu_leaf),
             ("6", "ResidualBlock_3", _rb_leaf),
             ("7", "SubpelConv3x3_0", _subpel_leaf)]

_CHENG_HA = [(str(i), f"Conv_{k}", _conv_leaf) for k, i in enumerate((0, 2, 4, 6, 8))]

_CHENG_HS = [("0", "Conv_0", _conv_leaf), ("2", "SubpelConv3x3_0", _subpel_leaf),
             ("4", "Conv_1", _conv_leaf), ("6", "SubpelConv3x3_1", _subpel_leaf),
             ("8", "Conv_2", _conv_leaf)]

_CHENG_EP = [("0", "Conv_0", _conv_leaf), ("2", "Conv_1", _conv_leaf),
             ("4", "Conv_2", _conv_leaf)]


def convert_cheng2020(sd: TorchSD) -> Tree:
    """A Cheng2020withCheckerboard state dict -> its flax params subtree."""

    def seq(prefix, layers):
        return {name: fn(_subtree(sd, f"{prefix}.{idx}")) for idx, name, fn in layers}

    return {
        "g_a": seq("g_a", _CHENG_GA),
        "g_s": seq("g_s", _CHENG_GS),
        "h_a": seq("h_a", _CHENG_HA),
        "h_s": seq("h_s", _CHENG_HS),
        "entropy_parameters": seq("entropy_parameters", _CHENG_EP),
        "context_prediction": _masked_conv_leaf(_subtree(sd, "context_prediction")),
        "entropy_bottleneck": _entropy_bottleneck_leaf(
            _subtree(sd, "entropy_bottleneck")),
    }


# -- MultiScaleRefine ------------------------------------------------------------


def _prelu(w: Array) -> Tree:
    return {"alpha": np.asarray(w).reshape(())}


def _plain_conv(sd: TorchSD, name: str, bias: bool = True) -> Tree:
    out: Tree = {"kernel": _t2j_conv(sd[f"{name}.weight"])}
    if bias:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def convert_refine(sd: TorchSD) -> Tree:
    """A MultiScaleRefine state dict -> its flax params subtree."""
    out: Tree = {
        "Conv_0": _plain_conv(sd, "conv_in"),
        "PReLU_0": _prelu(sd["act_in.weight"]),
        "SEBlock_0": {
            "Dense_0": {"kernel": np.transpose(sd["se_block.fc.0.weight"])},
            "Dense_1": {"kernel": np.transpose(sd["se_block.fc.2.weight"])},
        },
    }
    for i, scale in enumerate(("scale1", "scale2", "scale3")):
        out[f"_DilatedBlock_{i}"] = {
            "Conv_0": _plain_conv(sd, f"{scale}.0"),
            "PReLU_0": _prelu(sd[f"{scale}.1.weight"]),
            "Conv_1": _plain_conv(sd, f"{scale}.2"),
            "PReLU_1": _prelu(sd[f"{scale}.3.weight"]),
        }
    out["SpatialAttention_0"] = {"Conv_0": _plain_conv(sd, "spatial_att.conv", bias=False)}
    out["Conv_1"] = _plain_conv(sd, "fusion.0")
    out["PReLU_1"] = _prelu(sd["fusion.1.weight"])
    out["Conv_2"] = _plain_conv(sd, "fusion.2")
    return out


def convert_hyres(sd: TorchSD) -> Tree:
    """A ResidualJPEGCompression state dict -> ``{"params": tree}``.

    ``residual_model.*`` and ``refine.*`` are routed to their subtrees;
    any other key (the reference's stray top-level ``se_block.*``) is
    ignored.
    """
    return {"params": {
        "residual_model": convert_checkerboard(_subtree(sd, "residual_model")),
        "refine": convert_refine(_subtree(sd, "refine")),
    }}


def load_pth(path) -> TorchSD:
    """A ``.pth`` / ``.pth.tar`` file -> its state dict as numpy arrays.

    A training checkpoint's ``network`` or ``state_dict`` entry is
    unwrapped. The file is read with ``weights_only=True``: tensors and
    plain containers only, so loading runs no pickled code (a file that
    needs more raises ``pickle.UnpicklingError``).
    """
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("network", "state_dict"):
        if isinstance(raw, dict) and key in raw:
            raw = raw[key]
            break
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in raw.items()}


# -- export: a flax-layout tree -> reference state-dict arrays -----------------


def _export_sequential(tree: Tree, layers, prefix: str, out: Dict[str, Array]):
    for torch_idx, flax_name, kind in layers:
        node = tree[flax_name]
        base = f"{prefix}.{torch_idx}"
        if kind == "conv":
            out[f"{base}.weight"] = _j2t_conv(node["Conv_0"]["kernel"])
            if "bias" in node["Conv_0"]:
                out[f"{base}.bias"] = np.asarray(node["Conv_0"]["bias"])
        elif kind == "deconv":
            out[f"{base}.weight"] = _j2t_deconv(node["kernel"])
            if "bias" in node:
                out[f"{base}.bias"] = np.asarray(node["bias"])
        elif kind == "gdn":
            out[f"{base}.beta"] = np.asarray(node["beta"])
            out[f"{base}.gamma"] = np.asarray(node["gamma"])
        elif kind == "rbb":
            for i, tname in enumerate(("conv1", "conv2", "conv3")):
                leaf = node[f"Conv_{i}"]["Conv_0"]
                out[f"{base}.{tname}.weight"] = _j2t_conv(leaf["kernel"])
                out[f"{base}.{tname}.bias"] = np.asarray(leaf["bias"])
        elif kind == "attn":
            for ru in range(6):
                branch, unit = ("conv_a" if ru < 3 else "conv_b"), ru % 3
                for c, t_i in enumerate((0, 2, 4)):
                    leaf = node[f"_ResidualUnit_{ru}"][f"Conv_{c}"]["Conv_0"]
                    key = f"{base}.{branch}.{unit}.conv.{t_i}"
                    out[f"{key}.weight"] = _j2t_conv(leaf["kernel"])
                    out[f"{key}.bias"] = np.asarray(leaf["bias"])
            leaf = node["Conv_0"]["Conv_0"]
            out[f"{base}.conv_b.3.weight"] = _j2t_conv(leaf["kernel"])
            out[f"{base}.conv_b.3.bias"] = np.asarray(leaf["bias"])


def export_checkerboard(tree: Tree, prefix: str = "") -> Dict[str, Array]:
    """A flax-layout checkerboard tree -> reference state-dict arrays, the
    inverse of ``convert_checkerboard``."""
    p = (prefix + ".") if prefix else ""
    out: Dict[str, Array] = {}
    _export_sequential(tree["g_a"], _GA_LAYERS, p + "g_a", out)
    _export_sequential(tree["g_s"], _GS_LAYERS, p + "g_s", out)
    _export_sequential(tree["h_a"], _HA_LAYERS, p + "h_a", out)
    _export_sequential(tree["h_s"], _HS_LAYERS, p + "h_s", out)
    _export_sequential(tree["param_aggregation"], _PA_LAYERS,
                       p + "param_aggregation", out)
    out[p + "context_prediction.weight"] = _j2t_conv(tree["context_prediction"]["kernel"])
    out[p + "context_prediction.bias"] = np.asarray(tree["context_prediction"]["bias"])
    eb = tree["entropy_bottleneck"]
    out[p + "entropy_bottleneck.quantiles"] = np.asarray(eb["quantiles"])
    for k in range(5):
        out[p + f"entropy_bottleneck._matrices.{k}"] = np.asarray(eb[f"matrix_{k}"])
        out[p + f"entropy_bottleneck._biases.{k}"] = np.asarray(eb[f"bias_{k}"])
        if k < 4:
            out[p + f"entropy_bottleneck._factors.{k}"] = np.asarray(eb[f"factor_{k}"])
    return out


def export_refine(tree: Tree, prefix: str = "refine") -> Dict[str, Array]:
    """A flax-layout MultiScaleRefine tree -> reference state-dict arrays,
    the inverse of ``convert_refine`` (JAX's module has no refine export)."""
    out: Dict[str, Array] = {}

    def conv(name: str, node: Tree):
        out[f"{prefix}.{name}.weight"] = _j2t_conv(node["kernel"])
        if "bias" in node:
            out[f"{prefix}.{name}.bias"] = np.asarray(node["bias"])

    def prelu(name: str, node: Tree):
        out[f"{prefix}.{name}.weight"] = np.asarray(node["alpha"]).reshape(1)

    conv("conv_in", tree["Conv_0"])
    prelu("act_in", tree["PReLU_0"])
    for i, fc in enumerate(("fc.0", "fc.2")):
        out[f"{prefix}.se_block.{fc}.weight"] = np.transpose(
            tree["SEBlock_0"][f"Dense_{i}"]["kernel"])
    for i, scale in enumerate(("scale1", "scale2", "scale3")):
        block = tree[f"_DilatedBlock_{i}"]
        conv(f"{scale}.0", block["Conv_0"])
        prelu(f"{scale}.1", block["PReLU_0"])
        conv(f"{scale}.2", block["Conv_1"])
        prelu(f"{scale}.3", block["PReLU_1"])
    conv("spatial_att.conv", tree["SpatialAttention_0"]["Conv_0"])
    conv("fusion.0", tree["Conv_1"])
    prelu("fusion.1", tree["PReLU_1"])
    conv("fusion.2", tree["Conv_2"])
    return out


def export_hyres(params: Tree) -> Dict[str, Array]:
    """A HyRES ``params`` tree -> a reference state dict
    (``residual_model.*`` and ``refine.*``), the inverse of ``convert_hyres``."""
    out = export_checkerboard(params["residual_model"], "residual_model")
    out.update(export_refine(params["refine"]))
    return out
