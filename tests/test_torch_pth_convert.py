"""Reference ``.pth`` import in the port (``utils/torch_convert.py``).

State dicts with the reference's CompressAI names come from the torch
replicas of ``tests/test_torch_convert.py`` and ``tests/test_elic_convert.py``
(imported, not edited), their parameters redrawn from a numpy seed. Each
port converter's tree must equal JAX's ``hyres_tpu.utils.torch_convert``
tree leaf for leaf (same keys, ``np.array_equal``), and the port's module
loaded from it (``utils/convert.py load_state_dict``) must give the
replica's forward within 1e-4. ``load_pth`` reads reference-shaped files
and a ``.pth``-imported HyRES codec serves the bytes of the same weights
loaded through ``from_flax``.
"""

import pickle

import jax  # noqa: F401  (the JAX package's converter is the reference)
import numpy as np
import pytest
import torch
import torch.nn as tnn

from hyres_tpu.utils import torch_convert as jtc
from hyres_tpu_torch.utils import torch_convert as tc
from hyres_tpu_torch.utils.convert import load_state_dict, to_flax
from tests.test_elic_convert import TMaskedConv, tcc, tpa
from tests.test_torch_convert import (TRB, TRBS, TRBU, TRefine, build_torch_ga,
                                      build_torch_gs, tconv, tdeconv, tsubpel)

N, M = 8, 12
ATOL = 1e-4
CODER_BUFFERS = ("_quantized_cdf", "_offset", "_cdf_length")


def _redraw(module: tnn.Module, rng: np.random.Generator) -> tnn.Module:
    """Every parameter from the numpy seed: weights at 1/sqrt(fan-in),
    GDN's beta and gamma positive, so a transpose or flip shows."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "beta":
                v = rng.uniform(0.9, 1.1, p.shape)
            elif leaf == "gamma":
                v = rng.uniform(0.0, 0.3, p.shape)
            elif p.ndim >= 2:
                v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(p.shape[1:])), p.shape)
            else:  # biases, PReLU slopes
                v = rng.uniform(-0.2, 0.2, p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return module


def _sd(prefix: str, module: tnn.Module) -> dict:
    return {f"{prefix}.{k}": v.numpy() for k, v in module.state_dict().items()
            if not k.endswith("mask")}


def _eb_sd(C: int, rng: np.random.Generator, prefix: str = "entropy_bottleneck") -> dict:
    filters = (1, 3, 3, 3, 3, 1)
    sd = {f"{prefix}.quantiles": (np.array([-6.0, 0.0, 6.0], np.float32)
                                  + rng.uniform(-0.2, 0.2, (C, 1, 3))).astype(np.float32)}
    for k in range(5):
        sd[f"{prefix}._matrices.{k}"] = rng.uniform(
            -1, 1, (C, filters[k + 1], filters[k])).astype(np.float32)
        sd[f"{prefix}._biases.{k}"] = rng.uniform(
            -0.5, 0.5, (C, filters[k + 1], 1)).astype(np.float32)
        if k < 4:
            sd[f"{prefix}._factors.{k}"] = rng.uniform(
                -0.1, 0.1, (C, filters[k + 1], 1)).astype(np.float32)
    return sd


def _hyper(rng):
    h_a = tnn.Sequential(tnn.Conv2d(M, N, 3, padding=1), tnn.ReLU(),
                         tconv(N, N), tnn.ReLU(), tconv(N, N))
    h_s = tnn.Sequential(tdeconv(N, N), tnn.ReLU(), tdeconv(N, N * 3 // 2),
                         tnn.ReLU(), tnn.Conv2d(N * 3 // 2, 2 * M, 3, padding=1))
    return _redraw(h_a, rng), _redraw(h_s, rng)


def _checkerboard(seed: int = 0):
    """(state dict, {module name: replica}) of a LightWeightCheckerboard."""
    rng = np.random.default_rng(seed)
    h_a, h_s = _hyper(rng)
    pa = tpa(4 * M, 2 * M)
    cp = TMaskedConv(M, 2 * M)
    mods = {"g_a": build_torch_ga(N, M), "g_s": build_torch_gs(N, M), "h_a": h_a,
            "h_s": h_s, "param_aggregation": pa, "context_prediction": cp}
    sd = _eb_sd(N, rng)
    for name, m in mods.items():
        sd.update(_sd(name, _redraw(m, rng)))
    return sd, mods


def _elic(groups=(2, 2, 2, 3, 3), seed: int = 1):
    """An ELIC state dict of five slices (M=12), per-slice replicas."""
    rng = np.random.default_rng(seed)
    h_a, h_s = _hyper(rng)
    mods = {"g_a": build_torch_ga(N, M), "g_s": build_torch_gs(N, M), "h_a": h_a,
            "h_s": h_s}
    for i in range(1, len(groups)):
        cin = groups[0] + (groups[i - 1] if i > 1 else 0)
        mods[f"cc_transforms.{i - 1}"] = tcc(cin, 2 * groups[i])
    for i, g in enumerate(groups):
        mods[f"context_prediction.{i}"] = TMaskedConv(g, 2 * g)
        mods[f"ParamAggregation.{i}"] = tpa(2 * M + 2 * g + (2 * g if i else 0), 2 * g)
    sd = _eb_sd(N, rng)
    for name, m in mods.items():
        sd.update(_sd(name, _redraw(m, rng)))
    return sd, mods


def _cheng(n: int = 6, seed: int = 2):
    """A Cheng2020 state dict (N=M=n) from the CompressAI-named replicas."""
    rng = np.random.default_rng(seed)
    lrelu = tnn.LeakyReLU(0.01)

    def c3(cin, cout, s=1):
        return tnn.Conv2d(cin, cout, 3, stride=s, padding=1)

    mods = {
        "g_a": tnn.Sequential(TRBS(3, n), TRB(n), TRBS(n, n), TRB(n), TRBS(n, n), TRB(n),
                              c3(n, n, 2)),
        "g_s": tnn.Sequential(TRB(n), TRBU(n, n), TRB(n), TRBU(n, n), TRB(n), TRBU(n, n),
                              TRB(n), tsubpel(n, 3)),
        "h_a": tnn.Sequential(c3(n, n), lrelu, c3(n, n), lrelu, c3(n, n, 2), lrelu,
                              c3(n, n), lrelu, c3(n, n, 2)),
        "h_s": tnn.Sequential(c3(n, n), lrelu, tsubpel(n, n), lrelu, c3(n, n * 3 // 2),
                              lrelu, tsubpel(n * 3 // 2, n * 3 // 2), lrelu,
                              c3(n * 3 // 2, 2 * n)),
        "entropy_parameters": tnn.Sequential(
            tnn.Conv2d(4 * n, n * 10 // 3, 1), lrelu, tnn.Conv2d(n * 10 // 3, n * 8 // 3, 1),
            lrelu, tnn.Conv2d(n * 8 // 3, 2 * n, 1)),
        "context_prediction": TMaskedConv(n, 2 * n),
    }
    sd = _eb_sd(n, rng)
    for name, m in mods.items():
        sd.update(_sd(name, _redraw(m, rng)))
    return sd, mods


def _refine(seed: int = 3):
    tr = _redraw(TRefine(), np.random.default_rng(seed))
    return _sd("refine", tr), tr


def _hyres(seed: int = 4):
    sd, mods = _checkerboard(seed)
    sd = {f"residual_model.{k}": v for k, v in sd.items()}
    rsd, tr = _refine(seed)
    sd.update(rsd)
    return sd, mods, tr


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def assert_trees_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w), set(g) ^ set(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape)
        assert np.array_equal(a, b), k


# each builds its state dict afresh (numpy-seeded, so alike) and converts
# it with the module given: the port's or JAX's
CASES = {
    "checkerboard": lambda m: m.convert_checkerboard(_checkerboard()[0]),
    "elic": lambda m: m.convert_elic(_elic()[0], 5),
    "cheng2020": lambda m: m.convert_cheng2020(_cheng()[0]),
    "refine": lambda m: m.convert_refine(m._subtree(_refine()[0], "refine")),
    "hyres": lambda m: m.convert_hyres(_hyres()[0]),
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_tree_equals_jax_leaf_for_leaf(family):
    assert_trees_equal(CASES[family](tc), CASES[family](jtc))


def _close(got: torch.Tensor, want: torch.Tensor, atol: float = ATOL):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=atol)


def test_checkerboard_modules_match_replicas():
    from hyres_tpu_torch.models import LightWeightCheckerboard

    sd, mods = _checkerboard()
    model = LightWeightCheckerboard(N, M)
    load_state_dict(model, tc.convert_checkerboard(sd))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 3, 32, 32, generator=g)
    y = torch.rand(1, M, 4, 4, generator=g)
    with torch.no_grad():
        _close(model.g_a(x), mods["g_a"](x))
        _close(model.g_s(y), mods["g_s"](y))
        _close(model.h_a(y), mods["h_a"](y))
        z = torch.rand(1, N, 2, 2, generator=g)
        _close(model.h_s(z), mods["h_s"](z))
        pa_in = torch.rand(1, 4 * M, 4, 4, generator=g)
        _close(model.param_aggregation(pa_in), mods["param_aggregation"](pa_in))
        _close(model.context_prediction(y), mods["context_prediction"](y))


def test_elic_slices_match_replicas():
    from hyres_tpu_torch.models import LightWeightELIC

    groups = (2, 2, 2, 3, 3)
    sd, mods = _elic(groups)
    model = LightWeightELIC(N, M, groups=groups)
    load_state_dict(model, tc.convert_elic(sd, len(groups)))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        x = torch.rand(1, 3, 32, 32, generator=g)
        _close(model.g_a(x), mods["g_a"](x))
        for i, gi in enumerate(groups):
            if i:
                cin = groups[0] + (groups[i - 1] if i > 1 else 0)
                c = torch.rand(1, cin, 4, 4, generator=g)
                _close(getattr(model, f"cc_transforms_{i - 1}")(c),
                       mods[f"cc_transforms.{i - 1}"](c))
            ya = torch.rand(1, gi, 4, 4, generator=g)
            _close(getattr(model, f"context_prediction_{i}")(ya),
                   mods[f"context_prediction.{i}"](ya))
            p = torch.rand(1, 2 * M + 2 * gi + (2 * gi if i else 0), 4, 4, generator=g)
            _close(getattr(model, f"param_aggregation_{i}")(p),
                   mods[f"ParamAggregation.{i}"](p))


def test_cheng2020_transforms_match_replicas():
    from hyres_tpu_torch.models import Cheng2020withCheckerboard

    n = 6
    sd, mods = _cheng(n)
    model = Cheng2020withCheckerboard(n)
    load_state_dict(model, tc.convert_cheng2020(sd))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        x = torch.rand(1, 3, 64, 64, generator=g)
        y = torch.rand(1, n, 4, 4, generator=g)
        _close(model.g_a(x), mods["g_a"](x))
        _close(model.g_s(y), mods["g_s"](y))
        _close(model.h_a(y), mods["h_a"](y))
        z = torch.rand(1, n, 2, 2, generator=g)
        _close(model.h_s(z), mods["h_s"](z))
        e = torch.rand(1, 4 * n, 4, 4, generator=g)
        _close(model.entropy_parameters(e), mods["entropy_parameters"](e))
        _close(model.context_prediction(y), mods["context_prediction"](y))


def test_refine_matches_replica():
    from hyres_tpu_torch.nn import MultiScaleRefine

    sd, tr = _refine()
    model = MultiScaleRefine(mid_channels=64)
    load_state_dict(model, tc.convert_refine(tc._subtree(sd, "refine")))
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _close(model(x), tr(x))


def test_export_checkerboard_roundtrips_both_ways():
    sd, _ = _checkerboard(5)
    tree = tc.convert_checkerboard(sd)
    back = tc.export_checkerboard(tree, "residual_model")
    assert sorted(back) == sorted(f"residual_model.{k}" for k in sd)
    for k, v in sd.items():
        assert np.array_equal(back[f"residual_model.{k}"], v), k
    assert_trees_equal(tc.convert_checkerboard(tc.export_checkerboard(tree)), tree)
    jback = jtc.export_checkerboard(jtc.convert_checkerboard(sd), "residual_model")
    assert sorted(jback) == sorted(back)
    assert all(np.array_equal(jback[k], back[k]) for k in back)


def test_load_pth_unwraps_and_drops_coder_buffers(tmp_path):
    sd, _, _ = _hyres(6)
    extra = {f"residual_model.entropy_bottleneck.{b}": np.arange(5, dtype=np.int32)
             for b in CODER_BUFFERS}
    extra["residual_model.gaussian_conditional.scale_table"] = np.linspace(
        0.11, 256, 64, dtype=np.float32)
    extra["se_block.fc.0.weight"] = np.ones((4, 64), np.float32)
    full = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {**sd, **extra}.items()}
    want = tc.convert_hyres(sd)
    for i, wrapped in enumerate((
            {"network": full},
            {"epoch": 3, "state_dict": full, "optimizer": {"state": {}, "param_groups": [
                {"lr": 1e-4, "params": [0, 1]}]}, "loss": torch.tensor(1.5)},
            full)):
        path = tmp_path / f"ckpt{i}.pth.tar"
        torch.save(wrapped, path)
        got = tc.load_pth(path)
        assert sorted(got) == sorted(full)
        assert all(isinstance(v, np.ndarray) and np.array_equal(v, full[k].numpy())
                   for k, v in got.items())
        assert_trees_equal(tc.convert_hyres(got), want)
        assert_trees_equal(tc.convert_hyres(got), jtc.convert_hyres(got))


class _Opaque:
    pass


def test_load_pth_refuses_pickled_objects(tmp_path):
    path = tmp_path / "bad.pth"
    torch.save({"state_dict": {"w": torch.zeros(2)}, "args": _Opaque()}, path)
    with pytest.raises(pickle.UnpicklingError):
        tc.load_pth(path)


def test_export_hyres_roundtrips_both_ways():
    sd, _, _ = _hyres(7)
    params = tc.convert_hyres(sd)["params"]
    back = tc.export_hyres(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert_trees_equal(tc.convert_hyres(back)["params"], params)


def test_pth_imported_codec_serves_the_from_flax_bytes(tmp_path):
    """A seeded HyRES model, written as a reference ``.pth``, imported,
    and served on the CPU with the device coder: strings, JFIF bytes and
    ``x_hat`` equal those of a codec of the same weights by ``from_flax``."""
    from hyres_tpu_torch.models.hyres import HyresCodec, ResidualJPEGCompression
    from hyres_tpu_torch.nn import init_parameters

    src = init_parameters(ResidualJPEGCompression(16, 24),
                          torch.Generator().manual_seed(7))
    tree = to_flax(src)
    sd = tc.export_hyres(tree)
    sd["se_block.fc.0.weight"] = np.zeros((4, 64), np.float32)
    path = tmp_path / "hyres.pth.tar"
    torch.save({"epoch": 0, "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)

    imported = tc.convert_hyres(tc.load_pth(path))
    assert_trees_equal(imported["params"], tree)
    codecs = []
    for params in (imported["params"], tree):
        model = ResidualJPEGCompression(16, 24)
        load_state_dict(model, params)
        codec = HyresCodec(model, coder="device", device="cpu")
        assert codec.update()
        codecs.append(codec)
    x = torch.from_numpy(np.random.default_rng(8).random((1, 64, 64, 3)).astype(np.float32))
    ca, cb = (c.compress(x) for c in codecs)
    da, db = codecs[0].decompress(ca), codecs[1].decompress(cb)
    assert ca["strings"] == cb["strings"] and ca["jpeg_buffers"] == cb["jpeg_buffers"]
    assert torch.equal(da["x_hat"], db["x_hat"])
    for got, coded in zip(da["symbols"], ca["symbols"]):
        np.testing.assert_array_equal(got, coded)
