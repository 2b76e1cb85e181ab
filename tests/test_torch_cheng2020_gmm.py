"""Cheng2020 with attention and a Gaussian mixture (arXiv:2001.01568) on the
CPU, against the benchmark's plain reference.

Small width: N = M = 16, K = 3 on 64x64 inputs, the port's initialisers
from a seed, jittered, with the mixture's mean and scale biases spread as
the benchmark's configuration spreads them. The reference
(``portbench/reference/cheng2020-attn-gmm3-n192.py``, loaded by path) is
plain PyTorch on the same weights dict.

Bars: both training forwards' likelihoods and reconstructions within 1e-4
of each tensor's largest magnitude (at least 1; the two sum their
convolutions in other orders); the codec's symbols equal to the
reference's encode and its reconstruction to the reference's decode of
the same symbols; the plain row builder against a float64 mixture; exact
roundtrips through the plain coder, escapes included; the default model
unchanged; the host coder refused; the ``coder.gmm_rows`` span and
``GMM_STATS``; the three CLIs with ``--cheng-variant attn-gmm3``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import ndtr

from hyres_tpu_torch.coding import device_rans as dr
from hyres_tpu_torch.entropy import gaussian_likelihood
from hyres_tpu_torch.kernels import rans as krans
from hyres_tpu_torch.models import Cheng2020Codec, Cheng2020withCheckerboard
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.nn import init_parameters
from hyres_tpu_torch.utils import trace
from hyres_tpu_torch.utils.png import load_image, read_png, save_image

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N, K = 16, 3


def _load_reference():
    path = ROOT / "portbench" / "reference" / "cheng2020-attn-gmm3-n192.py"
    spec = importlib.util.spec_from_file_location("cheng_gmm_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seeded(seed=0):
    model = init_parameters(Cheng2020withCheckerboard(N, attention=True, mixtures=K),
                            torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        bias = model.entropy_parameters.Conv_2.Conv_0.bias
        for k, mean in enumerate((-1.5, 0.0, 1.5)):
            bias[(K + k) * N:(K + k + 1) * N] += mean
        bias[2 * K * N:] += 1.5
    return model.eval()


@pytest.fixture(scope="module")
def seeded():
    model = _seeded()
    W = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, W, REF.Reference({"mixtures": K, "N": N}, W)


def _crop(size=64, k=0):
    img = load_image(IMAGE)
    return torch.from_numpy(np.array(img[:, 96 * k: 96 * k + size, 128 * k: 128 * k + size]))


def _close(got, want, bar=1e-4):
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bar * scale, f"max err {err} against scale {scale}"


@pytest.mark.parametrize("mode", ["noise", "ste"])
def test_training_forwards_equal_reference(seeded, mode):
    model, _, ref = seeded
    x = _crop()
    noise = model.draw_noise(x.shape, torch.Generator().manual_seed(3), True, "cpu") \
        if mode == "noise" else None
    with torch.no_grad():
        out = model(x, noisequant=mode == "noise", noise=noise)
        x_hat, y_lik, z_lik = ref.forward(x, noise)
    _close(out["x_hat"], x_hat)
    _close(out["likelihoods"]["y"], y_lik)
    _close(out["likelihoods"]["z"], z_lik)
    assert out["likelihoods"]["y"].shape == (1, 4, 4, N)


@pytest.fixture(scope="module")
def coded(seeded):
    model, _, _ = seeded
    codec = Cheng2020Codec(model, coder="device", device="cpu")
    codec.update()
    x = _crop(k=1)
    tcodec.reset_gmm_stats()
    comp = codec.compress(x)
    stats = tcodec.gmm_stats()
    dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
    return codec, x, comp, dec, stats


def test_codec_symbols_and_reconstruction_equal_reference(seeded, coded):
    _, _, ref = seeded
    _, x, comp, dec, _ = coded
    with torch.no_grad():
        e = ref.encode(x)
        want = ref.decode(e["symbols"], x.shape[1], x.shape[2])
    for got, exp, back in zip(comp["symbols"], e["symbols"], dec["symbols"]):
        assert torch.equal(torch.as_tensor(got), exp)
        assert torch.equal(torch.as_tensor(back), exp)
    _close(dec["x_hat"], want)
    # the payload codes near the float64 mixture's ideal length, plus each
    # plane's frame (6 bytes and a 4-byte state a lane)
    ideal = ref.ideal_bits(e["symbols"]) / 8
    y_bytes = sum(len(b) for plane in comp["strings"][0] for b in plane)
    frames = 2 * (6 + 4 * 32)
    assert ideal < y_bytes <= 1.05 * ideal + frames


def _rows(params, padded):
    heads, rows = krans.gmm_rows_ref(params, K, padded)
    lo, k, nseg = (t[0].numpy() for t in krans.gmm_unpack_head(heads.long()))
    return lo, k, nseg, (rows[0].long() & 0xFFFF).numpy()


def test_rows_against_a_float64_mixture():
    """Each row's segments at least one slot, summing with the escape bin to
    2^16, and near the float64 mixture's mass on them: the weights' logit
    gaps round to 1/64 (each weight within 0.8%, the normalised mass within
    1.6%), the edges' standardised offsets to 1/4096 (a few slots)."""
    g = torch.Generator().manual_seed(5)
    M, P = 8, 40
    p = torch.randn((1, P, 3 * K * M), generator=g)
    p[..., K * M:2 * K * M] *= 5.0
    p[..., 2 * K * M:] = torch.exp(torch.randn((1, P, K * M), generator=g) * 1.5)
    n = P * M
    lo, k, nseg, rows = _rows(p, n + 64)
    logits, means, scales = (t.double().numpy()[0] for t in
                             p.unflatten(-1, (3, K, M)).unbind(-3))
    w = np.exp(logits - logits.max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    scales = np.maximum(scales, 0.11)
    for i in range(n):
        pix, c = divmod(i, M)
        ns = int(nseg[i])
        b = np.concatenate([[0], rows[i, :ns]])
        f = np.diff(b)
        assert f.min() >= 1 and b[-1] == dr.GAUSS_B
        assert (rows[i, ns:] == 0xFFFF).all()
        assert b[-1] + dr.GAUSS_ESC_FREQ == 1 << 16  # the escape bin closes the row
        edges = lo[i] + (np.arange(ns + 1) << k[i]) - 0.5
        cdf = (w[pix, :, c, None] * ndtr((edges[None] - means[pix, :, c, None])
                                         / scales[pix, :, c, None])).sum(0)
        want = dr.GAUSS_B * np.diff(cdf) / (cdf[-1] - cdf[0])
        assert (np.abs(f - want) <= 8 + 0.016 * want).all(), (i, f, want)
        assert cdf[-1] - cdf[0] > 1 - 1e-8  # the support holds the mixture's mass
    assert (lo[n:] == 0).all() and (nseg[n:] == 1).all()


@pytest.mark.parametrize("lanes,B", [(32, 1), (64, 2)])
def test_plain_coder_roundtrip_with_escapes(lanes, B):
    g = torch.Generator().manual_seed(lanes)
    M, P = 16, 70
    p = torch.randn((B, P, 3 * K * M), generator=g)
    p[..., 2 * K * M:] = p[..., 2 * K * M:].abs() + 0.3
    n = P * M
    _, padded, _ = dr.plane_geometry(n, lanes)
    heads, rows = krans.gmm_rows(p, K, padded)
    sym = torch.round(torch.randn((B, n), generator=g) * 3).to(torch.int32)
    sym[:, 3] = 29000
    sym[:, -1] = -31999
    enc = dr.encode([dr.gmm_plane(sym, heads, rows, lanes)])[0]
    assert int(enc["n_esc"].min()) >= 2
    dec = dr.gmm_decode(enc["stream"], enc["states"], heads, rows, enc["esc_pos"],
                        enc["esc_val"], lanes, n)
    assert torch.equal(dec, sym)
    # framed and unframed as the wire carries it
    frames = tcodec.DevicePlaneCoder.frames_from_enc({k: v.numpy() for k, v in enc.items()})
    _, states, stream, ep, ev = tcodec.DevicePlaneCoder.unframe_batch(frames, n)
    again = dr.gmm_decode(torch.from_numpy(stream.view(np.int16)),
                          torch.from_numpy(states.view(np.int32)), heads, rows,
                          torch.from_numpy(ep), torch.from_numpy(ev), lanes, n)
    assert torch.equal(again, sym)


def test_default_model_is_unchanged():
    """mixtures=1, attention=False is the reference's model: no attention
    block, 2N entropy-parameter outputs, the Gaussian likelihood."""
    a = Cheng2020withCheckerboard(N)
    b = Cheng2020withCheckerboard(N, attention=False, mixtures=1)
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}
    assert not any("AttentionBlock" in k for k in a.state_dict())
    assert a.entropy_parameters.Conv_2.Conv_0.weight.shape[0] == 2 * N
    init_parameters(a, torch.Generator().manual_seed(0))
    x = _crop()
    with torch.no_grad():
        y, z = a.analysis(x)
        hyper = a.hyper_synthesis(torch.round(z))
        p = a.mixture_params(torch.zeros(y.shape[:3] + (2 * N,)), hyper)
        scales, means = a.entropy_params(torch.zeros(y.shape[:3] + (2 * N,)), hyper)
        assert torch.equal(a.y_likelihood(y, p), gaussian_likelihood(y, scales, means))


def test_host_coder_refuses_a_mixture(seeded, coded):
    model, _, _ = seeded
    with pytest.raises(ValueError, match="only with the device coder"):
        Cheng2020Codec(model, coder="host", device="cpu")
    codec, _, comp, _, _ = coded
    with pytest.raises(ValueError, match="host-coder streams"):
        codec.decompress([[b"\x01\x00"], comp["strings"][1]], comp["shape"])


def test_gmm_stats_count_a_known_request(coded):
    """Two planes of rows an image (68 bytes each), every y symbol, its
    escapes (read from the frames' headers) and the widest support."""
    _, x, comp, _, stats = coded
    n = sum(torch.as_tensor(s).numel() for s in comp["symbols"][1:])
    padded = 2 * dr.plane_geometry(n // 2, 32)[1]
    assert stats["rows"] == padded and stats["row_bytes"] == 68 * padded
    assert stats["symbols"] == n
    assert stats["escapes"] == sum(b[1] for plane in comp["strings"][0] for b in plane)
    assert 1 <= stats["widest_support"] <= 64001
    tcodec.reset_gmm_stats()
    assert tcodec.gmm_stats() == {"rows": 0, "row_bytes": 0, "symbols": 0, "escapes": 0,
                                  "widest_support": 0}


def test_gmm_rows_span(coded, monkeypatch):
    """``coder.gmm_rows`` opens twice a compress and twice a decompress
    under a profiler, each inside a root; off, it costs the flag test."""
    codec, x, comp, _, _ = coded
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c = codec.compress(x)
        codec.decompress(c["strings"], c["shape"], c["size"])
    spans = [e for e in prof.events() if e.name == "hyres.coder.gmm_rows"]
    assert len(spans) == 4
    for e in spans:
        p = e.cpu_parent
        while p is not None and not p.name.startswith(("hyres.compress", "hyres.decompress")):
            p = p.cpu_parent
        assert p is not None
    assert c["strings"] == comp["strings"]

    def boom(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert codec.compress(x)["strings"] == comp["strings"]
    assert trace.span("coder.gmm_rows") is trace.span("coder.decode")


def test_clis_run_the_variant(tmp_path):
    """``--cheng-variant attn-gmm3``: cli.training steps once and writes a
    checkpoint, cli.codec encodes and decodes a .hyc from it on the device
    coder, and cli.inference roundtrips it."""
    from hyres_tpu_torch.cli import codec as cli_codec
    from hyres_tpu_torch.cli import inference as cli_inference
    from hyres_tpu_torch.cli import training as cli_training
    from hyres_tpu_torch.coding.container import unpack_compressed
    from hyres_tpu_torch.train import load_checkpoint

    img = read_png(IMAGE)
    for split, n in (("train", 2), ("test", 1)):
        (tmp_path / "ds" / split).mkdir(parents=True)
        for k in range(n):
            save_image(img[64 * k: 64 * k + 64, 96 * k: 96 * k + 64] / 255.0,
                       tmp_path / "ds" / split / f"{k}.png")
    variant = ["--model", "cheng2020", "--cheng-variant", "attn-gmm3", "--N", str(N)]
    cli_training.main(["-d", str(tmp_path / "ds"), "-e", "1", *variant,
                       "--patch-size", "64", "64", "--batch-size", "2",
                       "--test-batch-size", "1", "--num-workers", "1", "--device", "cpu",
                       "--savepath", str(tmp_path / "ck")])
    ckpt = tmp_path / "ck" / "checkpoint_last_0.msgpack"
    raw = load_checkpoint(ckpt)
    assert int(raw["step"]) == 1
    p = raw["params"]["params"]
    assert "AttentionBlock_1" in p["g_a"] and "AttentionBlock_0" in p["g_s"]
    assert np.asarray(p["entropy_parameters"]["Conv_2"]["Conv_0"]["kernel"]).shape[-1] == 9 * N
    src = tmp_path / "ds" / "test" / "0.png"
    cli_codec.main(["encode", "--checkpoint", str(ckpt), *variant, "--coder", "device",
                    "--device", "cpu", str(src), "-o", str(tmp_path / "enc")])
    hyc = tmp_path / "enc" / "0.hyc"
    assert unpack_compressed(hyc.read_bytes())["model"] == "cheng2020-attn-gmm3"
    cli_codec.main(["decode", "--checkpoint", str(ckpt), "--device", "cpu", str(hyc),
                    "-o", str(tmp_path / "dec")])
    assert read_png(tmp_path / "dec" / "0.png").shape == (64, 64, 3)
    cli_inference.main(["--checkpoint", str(ckpt), "--input", str(src), *variant,
                        "--coder", "device", "--device", "cpu", "--output",
                        str(tmp_path / "inf"), "--cold-timings"])
    assert (tmp_path / "inf" / "metrics.csv").is_file()
