"""The port's ELIC family (hyres_tpu_torch) against hyres_tpu on the CPU.

Small configuration of ``tests/test_elic.py``: N=16, M=24, groups (4, 4,
8, 8), 64x64 inputs (the CLI, whose model keeps the published groups,
runs N=16, M=320). Parameters are the port's flax initialisers from a
seed, jittered so that biases and GDN leave their initial values, and
go to JAX with ``to_flax`` and back with ``from_flax``; every noise
draw is JAX's, fed through the port's one noise function
``nn/quantizer.py uniform_noise``.

Bars: float stages and forwards within 1e-4 of each tensor's largest
magnitude (at least 1); frames of both coders byte-identical to JAX's
(``coder="host"`` / ``"tpu"``) with JAX's baked tables installed in the
port (a bake from the same parameters may land one CDF entry apart,
ROADMAP queue 3); each package decodes the other's strings to the same
symbols, and the port's own roundtrip is exact; ``inference_stream``
equals sequential requests bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.models import ElicCodec as JElicCodec
from hyres_tpu.models import LightWeightELIC as JElic
from hyres_tpu_torch.coding import device_rans
from hyres_tpu_torch.kernels import rans as krans
from hyres_tpu_torch.models import ElicCodec, LightWeightELIC
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.nn import init_parameters, quantizer
from hyres_tpu_torch.utils.convert import from_flax, to_flax
from hyres_tpu_torch.utils.png import load_image, read_png, save_image

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N, M, GROUPS = 16, 24, (4, 4, 8, 8)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, bar=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bar * scale, f"max err {err} against scale {scale}"


def _seeded(model_cls, *args, seed=0):
    """(port model, flax params tree) from the port's initialisers, jittered."""
    model = model_cls(*args)
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda p: p + rng.normal(0, 0.02, p.shape).astype(np.float32),
                          to_flax(model))
    model.load_state_dict(from_flax(params))
    return model.eval(), params


def _crops(n=3, size=64):
    img = load_image(IMAGE)
    return [np.array(img[:, 96 * k: 96 * k + size, 160 * k: 160 * k + size])
            for k in range(n)]


@pytest.fixture(scope="module")
def small():
    tm, params = _seeded(LightWeightELIC, N, M, GROUPS)
    return JElic(N=N, M=M, groups=GROUPS), {"params": params}, tm


def _tables(jc) -> dict:
    return {"gaussian": vars(jc.gauss_tables), "bottleneck": vars(jc.eb_tables)}


@pytest.fixture(scope="module")
def coded(small):
    """Per coder: JAX's and the port's compress + decompress of one crop,
    the port holding JAX's tables."""
    jm, params, tm = small
    x = _crops(1)[0]
    out = {}
    for jcoder, tcoder in (("host", "host"), ("tpu", "device")):
        jc = JElicCodec(jm, params, coder=jcoder)
        jc.update(force=True)
        cj = jc.compress(jnp.asarray(x))
        dj = jc.decompress(cj["strings"], cj["shape"])
        tc = ElicCodec(tm, coder=tcoder, device="cpu")
        tc.install_tables(_tables(jc))
        tcodec.reset_wire_stats()
        ct = tc.compress(torch.from_numpy(x))
        assert tcodec.WIRE_STATS["host_fallbacks"] == 0
        dt = tc.decompress(ct["strings"], ct["shape"], ct["size"])
        out[tcoder] = (jc, cj, np.asarray(dj["x_hat"]), tc, ct, dt)
    return out


def test_stages_equal_jax(small):
    """analysis, hyper_synthesis, and per slice the support, anchor and
    non-anchor parameters, each on JAX's inputs."""
    jm, params, tm = small
    x = _crops(1)[0]

    def japply(method, *args):
        return jax.tree.map(np.array, jm.apply(params, *args, method=method))

    y, z = japply(jm.analysis, jnp.asarray(x))
    with torch.no_grad():
        ty, tz = tm.analysis(torch.from_numpy(x))
        _close(ty, y)
        _close(tz, z)
        z_hat = np.round(z)
        means, scales = japply(jm.hyper_synthesis, jnp.asarray(z_hat))
        tmeans, tscales = tm.hyper_synthesis(torch.from_numpy(z_hat))
        _close(tmeans, means)
        _close(tscales, scales)
        y_hat = np.round(y)
        slices = np.split(y_hat, np.cumsum(GROUPS)[:-1], axis=-1)
        for i in range(len(GROUPS)):
            first, prev = (slices[0], slices[i - 1]) if i else (None, None)
            sup = japply(lambda mdl, *a: mdl.slice_support(i, *a), first, prev, means, scales)
            t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
            tsup = tm.slice_support(i, t(first), t(prev), t(means), t(scales))
            _close(tsup, sup)
            for jp, tp in zip(japply(lambda mdl, s: mdl.slice_anchor_params(i, s), sup),
                              tm.slice_anchor_params(i, t(sup))):
                _close(tp, jp)
            ya = np.array(slices[i])
            ya[:, 1::2, ::2] = ya[:, ::2, 1::2] = 0  # anchor class only
            for jp, tp in zip(
                    japply(lambda mdl, s, a: mdl.slice_nonanchor_params(i, s, a), sup, ya),
                    tm.slice_nonanchor_params(i, t(sup), t(ya))):
                _close(tp, jp)


def test_ste_forward_equals_jax(small):
    jm, params, tm = small
    x = np.stack([c[0] for c in _crops(2)])
    want = jm.apply(params, jnp.asarray(x), noisequant=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noisequant=False)
    _close(got["x_hat"], want["x_hat"])
    _close(got["likelihoods"]["y"], want["likelihoods"]["y"])
    _close(got["likelihoods"]["z"], want["likelihoods"]["z"])


def _jax_draws(key, tm, x_shape):
    """JAX's draws for one key, in the port's order: z's (C, 1, B*H*W),
    then per slice ``fold_in(rng_s, i)`` split into anchor and non-anchor."""
    y_shape, z_shape = tm.latent_shapes(x_shape)
    rng_z, rng_s = jax.random.split(key)
    B, h, w, C = z_shape
    draws = [jax.random.uniform(rng_z, (C, 1, B * h * w), jnp.float32, -0.5, 0.5)]
    for i, g in enumerate(GROUPS):
        for r in jax.random.split(jax.random.fold_in(rng_s, i)):
            draws.append(jax.random.uniform(r, y_shape[:3] + (g,), jnp.float32, -0.5, 0.5))
    return [np.asarray(d) for d in draws]


@pytest.mark.parametrize("noisequant", [True, False])
def test_noise_forward_equals_jax(small, monkeypatch, noisequant):
    """JAX's forward with a key against the port's with the same draws,
    through ``draw_noise`` (z's noise in both modes, y's in noise mode)."""
    jm, params, tm = small
    x = np.stack([c[0] for c in _crops(2)])
    key = jax.random.key(3)
    queue = _jax_draws(key, tm, x.shape)
    if not noisequant:
        queue = queue[:1]

    def uniform_noise(shape, generator, device):
        d = queue.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return torch.from_numpy(np.array(d)).to(device)

    monkeypatch.setattr(quantizer, "uniform_noise", uniform_noise)
    want = jm.apply(params, jnp.asarray(x), noisequant=noisequant, rng=key)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noisequant=noisequant,
                 generator=torch.Generator())
    assert not queue
    _close(got["x_hat"], want["x_hat"])
    _close(got["likelihoods"]["y"], want["likelihoods"]["y"])
    _close(got["likelihoods"]["z"], want["likelihoods"]["z"])


@pytest.mark.parametrize("coder", ["host", "device"])
def test_frames_equal_jax_and_cross_decode(coded, coder):
    jc, cj, xh_j, tc, ct, dt = coded[coder]
    assert len(ct["strings"][0]) == 2 * len(GROUPS)
    assert ct["strings"][0] == [list(s) for s in cj["strings"][0]]
    assert ct["strings"][1] == list(cj["strings"][1])
    assert all(device_rans.is_device_frame(f) == (coder == "device")
               for part in ct["strings"][0] for f in part)
    # the port's own roundtrip is exact
    for a, b in zip(ct["symbols"], dt["symbols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(dt["x_hat"], xh_j)
    # each package decodes the other's strings
    d_tj = tc.decompress(cj["strings"], cj["shape"])
    for a, b in zip(ct["symbols"], d_tj["symbols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d_jt = jc.decompress(ct["strings"], ct["shape"])
    _close(d_jt["x_hat"], xh_j)


def test_host_codec_refuses_device_frames(coded):
    _, _, _, tc, ct, _ = coded["device"]
    host = ElicCodec(tc.model, coder="host", device="cpu")
    host.install_tables(_tables(coded["host"][0]))
    with pytest.raises(ValueError, match="coder='device'"):
        host.decompress(ct["strings"], ct["shape"])


def test_inference_stream_equals_sequential(coded):
    tc = coded["device"][3]
    xs = [torch.from_numpy(c) for c in _crops(3)]
    seq = [tc.inference(x) for x in xs]
    streamed = tc.inference_stream(xs, depth=2)
    for s, o in zip(seq, streamed):
        assert o["strings"] == s["strings"]
        assert torch.equal(o["x_hat"], s["x_hat"])
        for a, b in zip(o["symbols"], s["symbols"]):
            assert torch.equal(a, b)


def test_encode_planes_refuses_more_than_the_cap_on_cpu():
    """The plain K3 refuses what the kernel refuses (16 planes a launch)."""
    z = torch.zeros((1, 1, 32), dtype=torch.int32)
    plane = krans.EncodePlane(z, z + 1, z, z + 16, 32)
    assert len(krans.encode_planes([plane] * 16)) == 16
    with pytest.raises(ValueError, match="at most 16 planes"):
        krans.encode_planes([plane] * 17)


def test_codec_and_inference_clis(tmp_path):
    """``--model elic`` (N=16, the published M=320 and groups) through the
    port's codec and inference CLIs on the device coder; JAX's codec CLI
    reads the port's .hyc to the same PNG within one level, from one
    artifact baked by the port's updata."""
    from hyres_tpu.cli import codec as jcli_codec
    from hyres_tpu_torch.cli import codec as tcli_codec
    from hyres_tpu_torch.cli import inference as tcli_inf
    from hyres_tpu_torch.cli import updata as tcli_updata
    from hyres_tpu_torch.coding import container
    from hyres_tpu_torch.train import save_checkpoint

    _, params = _seeded(LightWeightELIC, N, 320)
    save_checkpoint({"epoch": np.int64(0), "params": {"params": params}},
                    tmp_path / "raw.msgpack")
    tcli_updata.main(["--filepath", str(tmp_path / "raw.msgpack"), "--name", "elic",
                      "--dir", str(tmp_path), "--N", str(N), "--M", "320"])
    art = ["--checkpoint", str(tmp_path / "elic.msgpack")]
    src = tmp_path / "img.png"
    save_image(_crops(1)[0], src)
    tcli_codec.main(["encode", *art, "--model", "elic", "--N", str(N), "--coder", "device",
                     "--device", "cpu", str(src), "-o", str(tmp_path / "enc")])
    hyc = tmp_path / "enc" / "img.hyc"
    doc = container.unpack_compressed(hyc.read_bytes())
    assert (doc["model"], doc["N"], doc["M"], doc["coder"]) == ("elic", N, 192, "tpu")
    tcli_codec.main(["decode", *art, "--device", "cpu", str(hyc), "-o", str(tmp_path / "t")])
    jcli_codec.main(["decode", *art, str(hyc), "-o", str(tmp_path / "j")])
    t, j = (read_png(tmp_path / d / "img.png").astype(int) for d in ("t", "j"))
    assert np.abs(t - j).max() <= 1

    tcli_inf.main([*art, "--model", "elic", "--N", str(N), "--coder", "device",
                   "--device", "cpu", "--input", str(src), "--output", str(tmp_path / "inf"),
                   "--cold-timings"])
    text = (tmp_path / "inf" / "metrics.csv").read_text().splitlines()
    assert text[1].startswith("img.png,")
    assert float(text[1].split(",")[1]) * 64 * 64 / 8 == pytest.approx(
        sum(len(f) for p in doc["payload"]["strings"][0] for f in p)
        + sum(len(f) for f in doc["payload"]["strings"][1]))
    assert (tmp_path / "inf" / "fallbacks.txt").read_text().startswith("host_fallbacks=0")


def test_training_cli_trains_and_serves(tmp_path, capsys):
    """``cli.training --model elic`` (N=16; M takes the family's 320) runs an
    epoch on the CPU, and its raw checkpoint refits, bakes and serves
    through ``cli.inference``."""
    from hyres_tpu_torch.cli import inference as tcli_inf
    from hyres_tpu_torch.cli import training as tcli_train
    from hyres_tpu_torch.train import load_checkpoint

    img = read_png(IMAGE)
    for split, n in (("train", 4), ("test", 2)):
        (tmp_path / "ds" / split).mkdir(parents=True)
        for k in range(n):
            save_image(img[64 * k: 64 * k + 64, 96 * k: 96 * k + 64] / 255.0,
                       tmp_path / "ds" / split / f"{k}.png")
    tcli_train.main(["-d", str(tmp_path / "ds"), "-e", "1", "--model", "elic", "--N", str(N),
                     "--patch-size", "64", "64", "--batch-size", "2", "--test-batch-size", "2",
                     "--num-workers", "2", "--device", "cpu", "--savepath", str(tmp_path / "ck")])
    assert "model: N=16 M=320" in capsys.readouterr().out
    ckpt = tmp_path / "ck" / "checkpoint_last_0.msgpack"
    raw = load_checkpoint(ckpt)
    assert int(raw["step"]) == 2
    assert "param_aggregation_4" in raw["params"]["params"]
    tcli_inf.main(["--checkpoint", str(ckpt), "--model", "elic", "--N", str(N), "--device", "cpu",
                   "--input", str(tmp_path / "ds" / "test"), "--output", str(tmp_path / "inf"),
                   "--cold-timings"])
    rows = (tmp_path / "inf" / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["0.png", "1.png", "average", "median"]
