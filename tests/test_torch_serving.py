"""The serving entry points of the port against sequential runs and JAX.

Setup: the trained artifact at full width (N=128, M=192, JPEG quality 1),
loaded once per module, float32 on the CPU; 64x64 crops and the 128x128
crop of the in-repo image (a stream may mix sizes). The port's ``coder="device"`` runs the plain
versions of K1-K5 on CPU tensors; JAX's ``coder="tpu"`` is its
counterpart.

Bars:
- ``inference_stream`` against sequential ``inference`` on the same
  codec: strings and JFIF buffers byte-identical, ``x_hat`` equal
  (``torch.equal``), at depths 1, 2 and len+1 and with B=2 batches;
- against JAX's ``inference_stream``: strings byte-identical where the
  coded symbols are equal, bpp within 0.5% and PSNR within 0.02 dB of
  JAX's for each image (``tests/test_torch_codec.py``'s bars);
- tiled compression: the same bars against JAX's tiled path, and an exact
  own symbol roundtrip;
- ``lower_bound`` with a Python bound: equal to the tensor form, bit for
  bit for the positive bounds the port passes;
- a device-coder decompress parses the JFIF bytes after its K5 and both
  K4 calls and the residual synthesis (one ``overlapped_parses``; none on
  the host coder's path), with ``x_hat`` and the symbols equal to a
  sequential ``inference``'s.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.models import hyres as jhyres
from hyres_tpu.models import tiled as jtiled
from hyres_tpu.train.checkpoint import extract_variables, load_checkpoint
from hyres_tpu_torch.entropy import get_scale_table, lower_bound
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.models import hyres as thyres
from hyres_tpu_torch.models import tiled as ttiled
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = str(ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack")
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
CODERS = {"host": "host", "device": "tpu"}  # port coder -> JAX coder


def _crops():
    img = load_image(IMAGE)
    return [np.array(img[:, 64 * i: 64 * i + 64, 64 * j: 64 * j + 64])
            for i, j in ((0, 0), (3, 5), (6, 2))]


def _nbytes(comp, i=0):
    return (len(comp["jpeg_buffers"][i]) + sum(len(part[i]) for part in comp["strings"][0])
            + len(comp["strings"][1][i]))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(1 / mse)


@pytest.fixture(scope="module")
def port():
    return {c: thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder=c)
            for c in CODERS}


@pytest.fixture(scope="module")
def jax_codecs():
    raw = load_checkpoint(ARTIFACT)
    model = jhyres.ResidualJPEGCompression(N=128, M=192, jpeg_quality=1)
    out = {}
    for c, jc in CODERS.items():
        out[c] = jhyres.HyresCodec(model, extract_variables(raw), coder=jc)
        out[c].install_tables(raw["tables"])
    return out


def _assert_same_outputs(seq, st):
    assert len(seq) == len(st)
    for a, b in zip(seq, st):
        assert b["compressed"]["strings"] == a["compressed"]["strings"] == b["strings"]
        assert b["compressed"]["jpeg_buffers"] == a["compressed"]["jpeg_buffers"]
        assert b["shape"] == a["compressed"]["shape"]
        assert torch.equal(b["x_hat"], a["x_hat"])
        assert set(b["time"]) == {"compression", "decompression", "total"}


@pytest.mark.parametrize("coder", list(CODERS))
def test_stream_equals_sequential(port, coder):
    codec = port[coder]
    crop128 = np.array(load_image(IMAGE)[:, 256:384, 128:256])
    xs = [torch.from_numpy(x) for x in _crops() + [crop128]]
    seq = [codec.inference(x) for x in xs]
    for depth in (1, 2, len(xs) + 1):
        _assert_same_outputs(seq, codec.inference_stream(xs, depth=depth))
    # the decoded symbols are the coded ones
    for o in seq:
        for got, coded in zip(o["symbols"], o["compressed"]["symbols"]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(coded))


@pytest.mark.parametrize("coder", list(CODERS))
def test_stream_equals_sequential_batched(port, coder):
    codec = port[coder]
    c = [torch.from_numpy(x) for x in _crops()]
    xs = [torch.cat(c[:2]), torch.cat(c[1:])]
    _assert_same_outputs([codec.inference(x) for x in xs],
                         codec.inference_stream(xs, depth=2))


@pytest.mark.parametrize("coder", list(CODERS))
def test_stream_matches_jax(port, jax_codecs, coder):
    xs = _crops()[:2]
    outs = port[coder].inference_stream([torch.from_numpy(x) for x in xs], depth=2)
    jc = jax_codecs[coder]
    jouts = jc.inference_stream([jnp.asarray(x) for x in xs], depth=2)
    for x, o, jo in zip(xs, outs, jouts):
        comp, jcomp = o["compressed"], jo["compressed"]
        # JAX's symbols of this image, from its own stages
        (_, _, _), _, y, z_sym = jc._enc_front(jnp.asarray(x))
        r = jc._residual
        lp, a_idx, ma_p, a_sym = r._dec_stage1(z_sym, y)
        _, n_idx, _, n_sym = r._dec_stage2(lp, a_sym, ma_p, y)
        if all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in
               zip(comp["symbols"], (z_sym, a_sym, n_sym))):
            assert comp["strings"] == jcomp["strings"]
        bpp_t, bpp_j = (_nbytes(cc) * 8 / (64 * 64) for cc in (comp, jcomp))
        assert abs(bpp_t - bpp_j) <= 0.005 * bpp_j, (bpp_t, bpp_j)
        assert abs(_psnr(o["x_hat"].numpy(), x) - _psnr(np.asarray(jo["x_hat"]), x)) <= 0.02


@pytest.mark.parametrize("coder,framed_by", [("device", "device"), ("host", "host"),
                                             ("device", "host")])
def test_jfif_parse_runs_after_the_decode_chain(port, monkeypatch, coder, framed_by):
    """The order of a decompress's dispatch: under the device coder the
    decode chain (K5, then K4 on each half) and the residual synthesis are
    enqueued before the JFIF parse, and count one overlapped parse; the
    host coder, and a host-framed payload on a device-coder codec, decode
    on the host first and count none."""
    x = torch.from_numpy(np.array(load_image(IMAGE)[:, 256:384, 128:256]))
    ref = port[framed_by].inference(x)
    calls = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tcodec.DevicePlaneCoder, "decode_eb",
                        recorded("eb", tcodec.DevicePlaneCoder.decode_eb))
    monkeypatch.setattr(tcodec.DevicePlaneCoder, "decode_gauss",
                        recorded("gauss", tcodec.DevicePlaneCoder.decode_gauss))
    monkeypatch.setattr(tcodec.CheckerboardCodec, "dec_stage3",
                        recorded("synthesis", tcodec.CheckerboardCodec.dec_stage3))
    monkeypatch.setattr(thyres, "ParsedJpeg", recorded("parse", thyres.ParsedJpeg))
    tcodec.reset_wire_stats()
    dec = port[coder].decompress(ref["compressed"])
    on_device = framed_by == "device"
    assert calls == (["eb", "gauss", "gauss"] if on_device else []) + ["synthesis", "parse"]
    assert tcodec.WIRE_STATS["overlapped_parses"] == int(on_device)
    assert torch.equal(dec["x_hat"], ref["x_hat"])
    for got, want in zip(dec["symbols"], ref["symbols"]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    tcodec.reset_wire_stats()
    assert tcodec.WIRE_STATS["overlapped_parses"] == 0


def test_update_refuses_another_scale_table(port):
    codec = port["device"]
    table = get_scale_table()
    assert codec.update(scale_table=table) is False  # the bound table, baked
    with pytest.raises(ValueError, match="scale table"):
        codec.update(scale_table=table * 1.01)
    with pytest.raises(ValueError, match="scale table"):
        codec.update(scale_table=table[:10], force=True)


def test_tiled_matches_jax_and_roundtrips(port, jax_codecs):
    x = np.array(load_image(IMAGE)[:, 200:296, 300:460])  # 96 x 160
    comp = ttiled.tiled_compress(port["device"], torch.from_numpy(x), tile=64)
    assert comp["tile_grid"] == (2, 3, 64) and comp["image_size"] == (96, 160)
    dec = ttiled.tiled_decompress(port["device"], comp)
    for got, coded in zip(dec["symbols"], comp["symbols"]):
        assert torch.equal(got, coded)
    jcomp = jtiled.tiled_compress(jax_codecs["device"], jnp.asarray(x), tile=64)
    jdec = jtiled.tiled_decompress(jax_codecs["device"], jcomp)
    assert dec["x_hat"].shape == x.shape == jdec["x_hat"].shape
    n = sum(_nbytes(comp, i) for i in range(6))
    nj = sum(_nbytes(jcomp, i) for i in range(6))
    assert abs(n - nj) <= 0.005 * nj, (n, nj)
    assert abs(_psnr(dec["x_hat"].numpy(), x) - _psnr(np.asarray(jdec["x_hat"]), x)) <= 0.02
    # the edge-padded tiles: the bottom-right tile repeats the last row/column
    assert comp["jpeg_buffers"][5] != comp["jpeg_buffers"][0]


def test_lower_bound_float_equals_tensor_form():
    """Equal values for every bound (``torch.equal``: -0.0 equals 0.0, and
    a zero bound may keep the sign of a zero x), and equal bits for the
    positive bounds the port passes (GDN's reparametrisation, the
    likelihood bound)."""
    rng = np.random.default_rng(9)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, 3.4e38, -3.4e38,
                        np.finfo(np.float32).tiny, 1.0, -1.0], np.float32)
    x = np.concatenate([special, rng.normal(0, 1e-3, 500).astype(np.float32),
                        rng.normal(0, 10, 500).astype(np.float32)])
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        iv = torch.int32 if dt == torch.float32 else torch.int16
        for bound in (0.0, -0.0, 1e-39, (1e-6 + 2.0 ** -36) ** 0.5, 2.0 ** -18, 1e-9, -5.0):
            old = torch.maximum(xt, torch.tensor(bound, dtype=dt))
            new = lower_bound(xt, bound)
            assert torch.equal(new, old), (dt, bound)
            if bound > 0:
                assert torch.equal(new.view(iv), old.view(iv)), (dt, bound)
        tb = torch.full_like(xt, 0.5)
        assert torch.equal(lower_bound(xt, tb), torch.maximum(xt, tb))
