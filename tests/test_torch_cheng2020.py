"""The port's Cheng2020 family (hyres_tpu_torch) against hyres_tpu on the CPU.

Small configuration of ``tests/test_cheng2020.py``: N=24 on 64x64 inputs.
Parameters are the port's flax initialisers from a seed, jittered, carried
to JAX with ``to_flax`` and back with ``from_flax``; the new layers
(``pixel_shuffle``, ``SubpelConv3x3`` and the three residual blocks) take
JAX's own initialisation through ``from_flax``. Noise draws are JAX's,
fed through ``nn/quantizer.py uniform_noise``.

Bars: layers, stages and forwards within 1e-4 of each tensor's largest
magnitude (at least 1); frames of both coders byte-identical to JAX's,
with JAX's baked tables installed in the port: the host coder's ONE
stream an image carrying both passes, the device coder's frame list a
class; each package decodes the other's strings to the same symbols (a
swapped parity or a swapped (scales, means) split fails here); the port's
own roundtrip exact; ``inference_stream`` equal to sequential requests.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.models import Cheng2020Codec as JChengCodec
from hyres_tpu.models import Cheng2020withCheckerboard as JCheng
from hyres_tpu.models import codec as jcodec
from hyres_tpu.nn import layers as jl
from hyres_tpu_torch.coding import device_rans
from hyres_tpu_torch.models import Cheng2020Codec, Cheng2020withCheckerboard
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.nn import init_parameters, layers as tl, quantizer
from hyres_tpu_torch.utils.convert import from_flax, to_flax
from hyres_tpu_torch.utils.png import load_image, read_png, save_image

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N = 24


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


def _crops(n=3, size=64):
    img = load_image(IMAGE)
    return [np.array(img[:, 128 * k: 128 * k + size, 96 * k: 96 * k + size])
            for k in range(n)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,cin", [
    ("pixel_shuffle", 12), ("SubpelConv3x3", 6), ("ResidualBlock", 6),
    ("ResidualBlock", 8), ("ResidualBlockWithStride", 6), ("ResidualBlockUpsample", 8)])
def test_cheng_layers_equal_jax(name, cin):
    """Each new layer on JAX's initialisation (the 1x1 skip where the
    widths differ), 8 output channels, NCHW in the port."""
    x = np.random.default_rng(0).normal(size=(2, 8, 12, cin)).astype(np.float32)
    if name == "pixel_shuffle":
        want = jl.pixel_shuffle(jnp.asarray(x), 2)
        _close(_nhwc(tl.pixel_shuffle(_nchw(x), 2)), want, 0)
        return
    jmod = getattr(jl, name)(8)
    params = jmod.init(jax.random.key(1), jnp.asarray(x))["params"]
    params = jax.tree.map(  # GDN leaves its initial point
        lambda p: np.asarray(p) + np.random.default_rng(2).normal(0, 0.02, p.shape)
        .astype(np.float32), params)
    tmod = (getattr(tl, name)(cin, 8, 2) if name != "ResidualBlock"
            else tl.ResidualBlock(cin, 8))
    tmod.load_state_dict(from_flax(params))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _close(_nhwc(tmod(_nchw(x))), want)


def _seeded(seed=0):
    model = Cheng2020withCheckerboard(N)
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda p: p + rng.normal(0, 0.02, p.shape).astype(np.float32),
                          to_flax(model))
    model.load_state_dict(from_flax(params))
    return model.eval(), params


@pytest.fixture(scope="module")
def small():
    tm, params = _seeded()
    return JCheng(N=N), {"params": params}, tm


def _tables(jc) -> dict:
    return {"gaussian": vars(jc.gauss_tables), "bottleneck": vars(jc.eb_tables)}


@pytest.fixture(scope="module")
def coded(small):
    jm, params, tm = small
    x = _crops(1)[0]
    out = {}
    for jcoder, tcoder in (("host", "host"), ("tpu", "device")):
        jc = JChengCodec(jm, params, coder=jcoder)
        jc.update(force=True)
        cj = jc.compress(jnp.asarray(x))
        dj = jc.decompress(cj["strings"], cj["shape"])
        tc = Cheng2020Codec(tm, coder=tcoder, device="cpu")
        tc.install_tables(_tables(jc))
        tcodec.reset_wire_stats()
        ct = tc.compress(torch.from_numpy(x))
        assert tcodec.WIRE_STATS["host_fallbacks"] == 0
        dt = tc.decompress(ct["strings"], ct["shape"], ct["size"])
        out[tcoder] = (jc, cj, np.asarray(dj["x_hat"]), tc, ct, dt)
    return out


def test_stages_equal_jax(small):
    jm, params, tm = small
    x = _crops(1)[0]

    def japply(method, *args):
        return jax.tree.map(np.array, jm.apply(params, *args, method=method))

    y, z = japply(jm.analysis, jnp.asarray(x))
    hyper = japply(jm.hyper_synthesis, jnp.asarray(np.round(z)))
    ctx = japply(jm.context, jnp.asarray(np.round(y)))
    want = japply(jm.entropy_params, jnp.asarray(ctx), jnp.asarray(hyper))
    with torch.no_grad():
        ty, tz = tm.analysis(torch.from_numpy(x))
        _close(ty, y)
        _close(tz, z)
        _close(tm.hyper_synthesis(torch.from_numpy(np.round(z))), hyper)
        _close(tm.context(torch.from_numpy(np.round(y))), ctx)
        for got, w in zip(tm.entropy_params(torch.from_numpy(ctx), torch.from_numpy(hyper)),
                          want):
            _close(got, w)
        _close(tm.synthesis(torch.from_numpy(np.round(y))),
               japply(jm.synthesis, jnp.asarray(np.round(y))))


def test_ste_forward_equals_jax(small):
    """The two-pass STE path (the reference's ``_validate``)."""
    jm, params, tm = small
    x = np.stack([c[0] for c in _crops(2)])
    want = jm.apply(params, jnp.asarray(x), noisequant=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noisequant=False)
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k])
    _close(got["x_hat"], want["x_hat"])


def test_noise_forward_equals_jax(small, monkeypatch):
    """The single-pass noise path with JAX's two draws (z's, then y's)."""
    jm, params, tm = small
    x = np.stack([c[0] for c in _crops(2)])
    key = jax.random.key(5)
    y_shape, z_shape = tm.latent_shapes(x.shape)
    rng_z, rng_y = jax.random.split(key)
    B, h, w, C = z_shape
    queue = [np.asarray(jax.random.uniform(rng_z, (C, 1, B * h * w), jnp.float32, -0.5, 0.5)),
             np.asarray(jax.random.uniform(rng_y, y_shape, jnp.float32, -0.5, 0.5))]

    def uniform_noise(shape, generator, device):
        d = queue.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return torch.from_numpy(np.array(d)).to(device)

    monkeypatch.setattr(quantizer, "uniform_noise", uniform_noise)
    want = jm.apply(params, jnp.asarray(x), noisequant=True, rng=key)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noisequant=True, generator=torch.Generator())
    assert not queue
    assert tm.draw_noise(x.shape, torch.Generator(), False, "cpu") == {}
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k])
    _close(got["x_hat"], want["x_hat"])


@pytest.mark.parametrize("coder", ["host", "device"])
def test_frames_equal_jax_and_cross_decode(coded, coder):
    jc, cj, xh_j, tc, ct, dt = coded[coder]
    if coder == "host":  # one stream an image carries both passes
        assert len(ct["strings"][0]) == 1 and isinstance(ct["strings"][0][0], bytes)
        assert ct["strings"][0] == list(cj["strings"][0])
    else:  # one frame list a class
        assert ct["strings"][0] == [list(s) for s in cj["strings"][0]]
        assert all(device_rans.is_device_frame(f) for p in ct["strings"][0] for f in p)
    assert ct["strings"][1] == list(cj["strings"][1])
    for a, b in zip(ct["symbols"], dt["symbols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(dt["x_hat"], xh_j)
    d_tj = tc.decompress(cj["strings"], cj["shape"])
    for a, b in zip(ct["symbols"], d_tj["symbols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(jc.decompress(ct["strings"], ct["shape"])["x_hat"], xh_j)


def test_host_codec_refuses_device_frames(coded):
    tc, ct = coded["device"][3], coded["device"][4]
    host = Cheng2020Codec(tc.model, coder="host", device="cpu")
    host.install_tables(_tables(coded["host"][0]))
    with pytest.raises(ValueError, match="coder='device'"):
        host.decompress(ct["strings"], ct["shape"])


def test_inference_stream_equals_sequential(coded):
    tc = coded["device"][3]
    xs = [torch.from_numpy(c) for c in _crops(3)]
    seq = [tc.inference(x) for x in xs]
    for s, o in zip(seq, tc.inference_stream(xs, depth=2)):
        assert o["strings"] == s["strings"]
        assert torch.equal(o["x_hat"], s["x_hat"])
        for a, b in zip(o["symbols"], s["symbols"]):
            assert torch.equal(a, b)


def test_device_wire_equals_jax_call_by_call(small):
    """Three device-coder requests and their decodes: a first full-cap
    pull, then the speculative plan (a plane's first escapes miss it and
    re-pull). Per call the port's pulls, pulled bytes and uploaded bytes
    equal JAX's ``coder="tpu"``, ``cap_state`` equals JAX's, and the
    frames are byte-identical."""
    jm, params, tm = small
    jc = JChengCodec(jm, params, coder="tpu")
    jc.update(force=True)
    tc = Cheng2020Codec(tm, coder="device", device="cpu")
    tc.install_tables(_tables(jc))
    pulls = []
    for x in _crops(3):
        for w in (jcodec.WIRE_STATS, tcodec.WIRE_STATS):
            w.update(d2h_bytes=0, d2h_syncs=0, h2d_bytes=0, host_fallbacks=0)
        cj = jc.compress(jnp.asarray(x))
        ct = tc.compress(torch.from_numpy(x))
        assert ct["strings"][0] == [list(s) for s in cj["strings"][0]]
        assert ct["strings"][1] == list(cj["strings"][1])
        assert tc._enc_cap_state == jc._enc_cap_state
        jc.decompress(cj["strings"], cj["shape"])
        dt = tc.decompress(ct["strings"], ct["shape"], ct["size"])
        for a, b in zip(ct["symbols"], dt["symbols"]):
            assert torch.equal(a, b)
        counts = [(w["d2h_syncs"], w["d2h_bytes"], w["h2d_bytes"], w["host_fallbacks"])
                  for w in (jcodec.WIRE_STATS, tcodec.WIRE_STATS)]
        assert counts[1] == counts[0] and counts[1][3] == 0
        pulls.append(counts[1][0])
    assert pulls[0] == 1 and max(pulls) <= 2


def test_codec_cli_cross_reads_hyc(tmp_path):
    """``--model cheng2020`` .hyc files of both coders: the port's read by
    JAX's codec CLI and JAX's by the port's, each to the same PNG within one
    level, from one artifact baked by the port's updata."""
    from hyres_tpu.cli import codec as jcli_codec
    from hyres_tpu_torch.cli import codec as tcli_codec
    from hyres_tpu_torch.cli import updata as tcli_updata
    from hyres_tpu_torch.train import save_checkpoint

    _, params = _seeded(1)
    save_checkpoint({"epoch": np.int64(0), "params": {"params": params}},
                    tmp_path / "raw.msgpack")
    tcli_updata.main(["--filepath", str(tmp_path / "raw.msgpack"), "--name", "cheng",
                      "--dir", str(tmp_path), "--N", str(N)])
    art = ["--checkpoint", str(tmp_path / "cheng.msgpack")]
    src = tmp_path / "img.png"
    save_image(_crops(1)[0], src)
    enc = ["encode", *art, "--model", "cheng2020", "--N", str(N), str(src)]
    for tc, jc in (("host", "host"), ("device", "tpu")):
        tcli_codec.main([*enc, "--coder", tc, "--device", "cpu", "-o", str(tmp_path / f"t{tc}")])
        jcli_codec.main([*enc, "--coder", jc, "-o", str(tmp_path / f"j{tc}")])
        t_hyc, j_hyc = (tmp_path / f"{p}{tc}" / "img.hyc" for p in "tj")
        assert t_hyc.read_bytes() == j_hyc.read_bytes()
        tcli_codec.main(["decode", *art, "--device", "cpu", str(j_hyc),
                         "-o", str(tmp_path / f"td{tc}")])
        jcli_codec.main(["decode", *art, str(t_hyc), "-o", str(tmp_path / f"jd{tc}")])
        t, j = (read_png(tmp_path / f"{p}{tc}" / "img.png").astype(int) for p in ("td", "jd"))
        assert np.abs(t - j).max() <= 1


def test_training_cli_trains(tmp_path):
    """``cli.training --model cheng2020`` runs an epoch (noise mode) on the
    CPU and writes a checkpoint in the reference's layout."""
    from hyres_tpu_torch.cli import training as tcli_train
    from hyres_tpu_torch.train import load_checkpoint

    img = read_png(IMAGE)
    for split, n in (("train", 4), ("test", 2)):
        (tmp_path / "ds" / split).mkdir(parents=True)
        for k in range(n):
            save_image(img[64 * k: 64 * k + 64, 96 * k: 96 * k + 64] / 255.0,
                       tmp_path / "ds" / split / f"{k}.png")
    tcli_train.main(["-d", str(tmp_path / "ds"), "-e", "1", "--model", "cheng2020",
                     "--N", str(N), "--patch-size", "64", "64", "--batch-size", "2",
                     "--test-batch-size", "2", "--num-workers", "2", "--device", "cpu",
                     "--savepath", str(tmp_path / "ck")])
    raw = load_checkpoint(tmp_path / "ck" / "checkpoint_last_0.msgpack")
    assert int(raw["step"]) == 2
    p = raw["params"]["params"]
    assert {"g_a", "g_s", "h_a", "h_s", "entropy_parameters", "context_prediction",
            "entropy_bottleneck"} == set(p)
    assert np.asarray(p["g_s"]["SubpelConv3x3_0"]["Conv_0"]["Conv_0"]["kernel"]).shape == (
        3, 3, N, 12)
