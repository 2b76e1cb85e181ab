"""The slice as a whole: the port's HyRES roundtrips vs JAX's.

Setup: the trained artifact's weights and baked tables at full width
(N=128, M=192, JPEG quality 1), a 128x128 crop of the in-repo image,
``hyres_tpu.models.hyres.HyresCodec(coder="host")`` against
``hyres_tpu_torch.models.hyres.HyresCodec(device="cpu")``, and JAX's
``coder="tpu"`` against the port's ``coder="device"`` (the device rANS
coder through the plain versions of K3-K5 on CPU tensors).

Tolerances (float32):
- stage tensors (y, latent params, means): atol 1e-4 (summation order of
  the two frameworks' CPU convolutions);
- symbols and scale indexes: equal except at most 0.1% off by one (a
  float value within rounding of .5, or of a scale-table edge);
- the port's own roundtrip: decoded symbols equal the coded ones exactly;
- JPEG buffers: byte-identical when the coefficients are;
- bpp within 0.5% and PSNR within 0.02 dB of JAX's.
bfloat16 rounds in different places in the two frameworks, so there the
symbols drift apart; the bf16 bars are bpp within 3% and PSNR within
0.1 dB of JAX's bf16 run, and an exact own roundtrip.
Device coder (float32): residual strings byte-identical to JAX's where
the symbols and indexes are equal (the coder is exact integer work),
an exact own roundtrip, bpp within 0.5% and PSNR within 0.02 dB.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.models import hyres as jhyres
from hyres_tpu.train.checkpoint import extract_variables, load_checkpoint
from hyres_tpu_torch.coding import device_rans
from hyres_tpu_torch.models import checkerboard as tcb
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.models import hyres as thyres
from hyres_tpu_torch.utils.convert import from_flax
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = str(ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack")
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"


def _crop():
    return np.array(load_image(IMAGE)[:, 256:384, 128:256])


def _nbytes(comp):
    return (sum(len(b) for b in comp["jpeg_buffers"])
            + sum(len(s) for part in comp["strings"][0] for s in part)
            + sum(len(s) for s in comp["strings"][1]))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(1 / mse)


def _jax_codec(compute_dtype, coder="host"):
    raw = load_checkpoint(ARTIFACT)
    model = jhyres.ResidualJPEGCompression(N=128, M=192, jpeg_quality=1,
                                           compute_dtype=compute_dtype)
    codec = jhyres.HyresCodec(model, extract_variables(raw), coder=coder)
    codec.install_tables(raw["tables"])
    return codec


def _run_jax(compute_dtype, x):
    codec = _jax_codec(compute_dtype)
    xj = jnp.asarray(x)
    (cy, ccb, ccr), _, y, z_sym = codec._enc_front(xj)
    r = codec._residual
    lp, a_idx, ma_p, a_sym = r._dec_stage1(z_sym, y)
    _, n_idx, mn_p, n_sym = r._dec_stage2(lp, a_sym, ma_p, y)
    comp = codec.compress(xj)
    x_hat = codec.decompress(comp)["x_hat"]
    stages = dict(coef=(cy, ccb, ccr), y=y, lp=lp, ma_p=ma_p, mn_p=mn_p,
                  z_sym=z_sym, a_sym=a_sym, n_sym=n_sym, a_idx=a_idx, n_idx=n_idx)
    return jax.tree.map(np.array, stages), comp, np.array(x_hat)


def _run_port(compute_dtype, x):
    codec = thyres.HyresCodec.from_artifact(ARTIFACT, compute_dtype=compute_dtype,
                                            device="cpu")
    xt = torch.from_numpy(x)
    coefs, y, z_sym = codec.enc_front(xt)
    r = codec._residual
    lp, a_idx, ma_p, a_sym = r.dec_stage1(z_sym, y)
    _, n_idx, mn_p, n_sym = r.dec_stage2(lp, a_sym, ma_p, y)
    comp = codec.compress(xt)
    dec = codec.decompress(comp)
    stages = dict(coef=tuple(coefs), y=y, lp=lp, ma_p=ma_p, mn_p=mn_p, z_sym=z_sym,
                  a_sym=a_sym, n_sym=n_sym, a_idx=a_idx, n_idx=n_idx)
    stages = {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy())
              for k, v in stages.items()}
    return stages, comp, dec


@pytest.fixture(scope="module")
def f32_runs():
    x = _crop()
    return x, _run_jax(None, x), _run_port(None, x)


@pytest.fixture(scope="module")
def device_runs():
    """JAX's coder="tpu" and the port's coder="device" on the crop, f32."""
    x = _crop()
    jc = _jax_codec(None, coder="tpu")
    comp_j = jc.compress(jnp.asarray(x))
    xh_j = np.array(jc.decompress(comp_j)["x_hat"])
    codec = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")
    comp_t = codec.compress(torch.from_numpy(x))
    return x, (comp_j, xh_j), (comp_t, codec.decompress(comp_t))


@pytest.fixture(scope="module")
def bf16_runs():
    x = _crop()
    return x, _run_jax(jnp.bfloat16, x), _run_port(torch.bfloat16, x)


def _assert_ints_close(got, want, name):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape, name
    diff = np.abs(got - want)
    assert diff.max() <= 1, f"{name}: max diff {diff.max()}"
    assert np.sum(diff != 0) <= 0.001 * got.size, f"{name}: {np.sum(diff != 0)} differ"


def test_stage_tensors_match(f32_runs):
    _, (js, _, _), (ts, _, _) = f32_runs
    for k in ("y", "lp", "ma_p", "mn_p"):
        assert ts[k].shape == js[k].shape, k
        np.testing.assert_allclose(ts[k], js[k], atol=1e-4, rtol=0, err_msg=k)


def test_symbols_and_indexes_match(f32_runs):
    _, (js, _, _), (ts, _, _) = f32_runs
    for k in ("z_sym", "a_sym", "n_sym", "a_idx", "n_idx"):
        _assert_ints_close(ts[k], js[k], k)
    for g, w in zip(ts["coef"], js["coef"]):
        _assert_ints_close(g, w, "jpeg coefficients")


def test_port_roundtrip_symbols_exact(f32_runs):
    _, _, (ts, comp, dec) = f32_runs
    for got, coded, want in zip(dec["symbols"], comp["symbols"],
                                (ts["z_sym"], ts["a_sym"], ts["n_sym"])):
        np.testing.assert_array_equal(got, coded)
        np.testing.assert_array_equal(coded, want)


def test_jpeg_buffers_identical_where_coefficients_are(f32_runs):
    _, (js, comp_j, _), (ts, comp_t, _) = f32_runs
    same = all(np.array_equal(g, w) for g, w in zip(ts["coef"], js["coef"]))
    if same:
        assert comp_t["jpeg_buffers"] == comp_j["jpeg_buffers"]
    else:  # a .5 tie moved a coefficient: the bytes may legitimately differ
        assert len(comp_t["jpeg_buffers"]) == len(comp_j["jpeg_buffers"])


def test_rate_and_quality_match(f32_runs):
    x, (_, comp_j, xh_j), (_, comp_t, dec) = f32_runs
    xh_t = dec["x_hat"].numpy()
    assert xh_t.shape == x.shape and np.isfinite(xh_t).all()
    bpp_j, bpp_t = (_nbytes(c) * 8 / (x.shape[1] * x.shape[2]) for c in (comp_j, comp_t))
    assert abs(bpp_t - bpp_j) <= 0.005 * bpp_j, (bpp_t, bpp_j)
    assert abs(_psnr(xh_t, x) - _psnr(xh_j, x)) <= 0.02
    assert comp_t["shape"] == comp_j["shape"] and comp_t["size"] == comp_j["size"]


def test_bf16_run(bf16_runs):
    x, (_, comp_j, xh_j), (ts, comp_t, dec) = bf16_runs
    for got, coded in zip(dec["symbols"], comp_t["symbols"]):
        np.testing.assert_array_equal(got, coded)
    xh_t = dec["x_hat"].numpy()
    assert xh_t.dtype == np.float32 and np.isfinite(xh_t).all()
    bpp_j, bpp_t = (_nbytes(c) * 8 / (x.shape[1] * x.shape[2]) for c in (comp_j, comp_t))
    assert abs(bpp_t - bpp_j) <= 0.03 * bpp_j, (bpp_t, bpp_j)
    assert abs(_psnr(xh_t, x) - _psnr(xh_j, x)) <= 0.1


def test_small_width_codec_bakes_tables_and_roundtrips(rng_np):
    """Random small-width parameters, tables baked by update(): exact
    symbol roundtrip through the host coder, batch of two."""
    from hyres_tpu.models.checkerboard import LightWeightCheckerboard  # params only

    x = rng_np.random((2, 64, 64, 3)).astype(np.float32) - 0.5
    params = LightWeightCheckerboard(16, 24).init(jax.random.PRNGKey(5),
                                                  jnp.asarray(x))["params"]
    model = tcb.LightWeightCheckerboard(16, 24)
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    codec = tcodec.CheckerboardCodec(model, clamp=None, device="cpu")
    with pytest.raises(RuntimeError):
        codec.compress(torch.from_numpy(x))
    assert codec.update() and not codec.update()
    comp = codec.compress(torch.from_numpy(x))
    dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
    for got, coded in zip(dec["symbols"], comp["symbols"]):
        np.testing.assert_array_equal(got, coded)
    assert dec["x_hat"].shape == x.shape


def test_device_coder_strings_identical_to_jax(f32_runs, device_runs):
    _, (js, _, _), (ts, _, _) = f32_runs
    _, (comp_j, _), (comp_t, _) = device_runs
    same = all(np.array_equal(ts[k], js[k])
               for k in ("z_sym", "a_sym", "n_sym", "a_idx", "n_idx"))
    if same:
        assert comp_t["strings"] == comp_j["strings"]
    assert all(device_rans.is_device_frame(f) for part in comp_t["strings"][0]
               for f in part)
    assert all(device_rans.is_device_frame(f) for f in comp_t["strings"][1])


def test_device_coder_roundtrip_exact(f32_runs, device_runs):
    _, _, (ts, _, _) = f32_runs
    _, _, (comp_t, dec) = device_runs
    for got, coded, want in zip(dec["symbols"], comp_t["symbols"],
                                (ts["z_sym"], ts["a_sym"], ts["n_sym"])):
        assert got.dtype == coded.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), coded.numpy())
        np.testing.assert_array_equal(coded.numpy(), want)


def test_device_coder_rate_and_quality(device_runs):
    x, (comp_j, xh_j), (comp_t, dec) = device_runs
    xh_t = dec["x_hat"].numpy()
    assert xh_t.shape == x.shape and np.isfinite(xh_t).all()
    bpp_j, bpp_t = (_nbytes(c) * 8 / (x.shape[1] * x.shape[2]) for c in (comp_j, comp_t))
    assert abs(bpp_t - bpp_j) <= 0.005 * bpp_j, (bpp_t, bpp_j)
    assert abs(_psnr(xh_t, x) - _psnr(xh_j, x)) <= 0.02
    assert comp_t["jpeg_buffers"] == comp_j["jpeg_buffers"]


def test_device_coder_overflow_reframes_with_host_coder(monkeypatch, f32_runs):
    """A plane over its stream cap re-frames the batch with the host coder
    (counted in WIRE_STATS); the payload still decodes exactly, and its
    residual strings are the host coder's."""
    _, _, (_, comp_host, _) = f32_runs
    x = _crop()
    codec = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")
    monkeypatch.setattr(device_rans, "stream_cap", lambda n, lanes, words=1: 16)
    tcodec.reset_wire_stats()
    comp = codec.compress(torch.from_numpy(x))
    assert tcodec.WIRE_STATS["host_fallbacks"] == 1
    assert "stream cap" in tcodec.WIRE_STATS["fallback_reasons"][-1]
    assert comp["strings"] == comp_host["strings"]
    dec = codec.decompress(comp)
    for got, coded in zip(dec["symbols"], comp["symbols"]):
        np.testing.assert_array_equal(np.asarray(got), coded.numpy())


def test_device_coder_batch_equals_single_requests():
    """A batch of two through the device coder gives each image the bytes
    of its own single-image request and decodes both exactly."""
    x = _crop()
    xb = np.concatenate([x, x[:, ::-1].copy()])
    codec = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")
    tcodec.reset_wire_stats()
    comp = codec.compress(torch.from_numpy(xb))
    # a first batched call pulls the size rows, then the exactly sliced blob
    assert tcodec.WIRE_STATS["d2h_syncs"] == 2
    assert tcodec.WIRE_STATS["host_fallbacks"] == 0
    dec = codec.decompress(comp)
    for got, coded in zip(dec["symbols"], comp["symbols"]):
        assert torch.equal(got, coded)
    for i in range(2):
        single = codec.compress(torch.from_numpy(xb[i:i + 1]))
        assert single["jpeg_buffers"][0] == comp["jpeg_buffers"][i]
        assert single["strings"][1][0] == comp["strings"][1][i]
        for part in range(2):
            assert single["strings"][0][part][0] == comp["strings"][0][part][i]
        # the same symbols; the convolutions sum in another order at batch 2
        np.testing.assert_allclose(codec.decompress(single)["x_hat"].numpy()[0],
                                   dec["x_hat"].numpy()[i], atol=1e-6, rtol=0)


def test_host_coder_refuses_device_frames(device_runs):
    _, _, (comp_t, _) = device_runs
    host = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu")
    with pytest.raises(ValueError, match="coder='device'"):
        host.decompress(comp_t)


def test_entry_points_refuse_what_this_slice_lacks():
    model = thyres.ResidualJPEGCompression(16, 24)
    with pytest.raises(ValueError, match="device"):
        thyres.HyresCodec(model, coder="tpu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thyres.HyresCodec(model)  # device defaults to the card


def test_frame_unframe_roundtrip():
    chunks = [b"", b"abc", bytes(range(256))]
    assert tcodec._unframe(tcodec._frame(chunks)) == chunks
