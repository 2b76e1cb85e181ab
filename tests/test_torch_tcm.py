"""TCM (``models/tcm.py``, ``models/tcm_codec.py``, ``nn/swin.py``) and the
plain version of its window attention K7 (``kernels/window_attn.py``) on
the CPU, against the benchmark's plain reference
(``portbench/reference/tcm-n128-m320.py``), which imports nothing of the
port and does its attention by literal roll, partition, einsum, mask and
softmax.

Sizes: N=32 (heads of 8, 16 and 32 all split it), M=40 (five slices of 8),
192 -> 48 hyper channels, SWAtten at width 32, on 128x128 inputs (the pad
multiple) and a 100x70 one, windows 8 (4 in the hyper transforms), and
the stages also with windows 4 throughout. Weights come from the
benchmark's own recipe (``configs/tcm-n128-m320.py``: the seeded
initialisers, the blocks' joining convolutions at 0.1, the scale stacks'
bias, the prior fitted to a crop of the photo), so that values stay of
order one through the stacks. Two threads, as the other family files.

Bars: each stage within 1e-4 of the reference's largest magnitude (float32
through up to thirty layers whose sums run in other orders); symbols
exact; the roundtrip's x_hat within 1e-4 of the reference's decode.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import spec  # noqa: E402

from hyres_tpu_torch.kernels import window_attn as k7  # noqa: E402
from hyres_tpu_torch.models import TcmCodec  # noqa: E402
from hyres_tpu_torch.nn.swin import WindowAttention  # noqa: E402

REF = spec.load_module(ROOT / "portbench" / "reference" / "tcm-n128-m320.py")
CFGMOD = spec.load_module(ROOT / "portbench" / "configs" / "tcm-n128-m320.py")
BASE = json.loads((ROOT / "portbench" / "configs" / "tcm-n128-m320.json").read_text())
SMALL = {"N": 32, "M": 40, "z_channels": 48, "swatten_inter": 32, "prior_fit_steps": 5,
         "prior_fit_crop": [128, 256, 256, 384], "name": "tcm-n128-m320"}
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _build(window: int):
    cfg = {**BASE, **SMALL, "window": window}
    W = CFGMOD.reference_weights(cfg, ROOT, torch.device("cpu"), REF)
    model = CFGMOD._model(cfg)
    model.load_state_dict(W)
    return cfg, W, model.eval(), REF.Reference(cfg, W)


@pytest.fixture(scope="module")
def setup():
    return _build(8)


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert err <= TOL * max(float(want.abs().max()), 1.0), (what, err)


def _photo(h, w, oy=0, ox=0):
    from hyres_tpu_torch.utils.png import load_image

    img = torch.from_numpy(load_image(ROOT / BASE["prior_fit_photo"]))
    return img[:, oy:oy + h, ox:ox + w].contiguous()


# -- K7's plain version ------------------------------------------------------

@pytest.mark.parametrize("shifted", [False, True], ids=["W", "SW"])
@pytest.mark.parametrize("H,W,C,d,p", [(16, 24, 32, 8, 8), (8, 12, 32, 16, 4),
                                       (24, 16, 64, 32, 8), (12, 8, 32, 8, 4)])
def test_window_attention_matches_the_reference_literal_attention(H, W, C, d, p, shifted):
    """``WindowAttention`` (the Linear, K7's plain version through its index
    map, the output Linear) against the reference's roll, partition, einsum,
    mask and softmax, on a batch of 2 with a random relative-position
    table."""
    g = torch.Generator().manual_seed(H * W + C + d + p)
    m = WindowAttention(C, d, p, shifted)
    with torch.no_grad():
        m.relative_position_params.normal_(0.0, 1.0, generator=g)
        m.Dense_0.bias.normal_(0.0, 0.3, generator=g)
    x = torch.randn((2, H, W, C), generator=g)
    Wd = {f"a.{k}": v for k, v in m.state_dict().items()}
    with torch.no_grad():
        torch.testing.assert_close(m(x), REF.wmsa(Wd, "a", x, d, p, shifted),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw,ww,p", [(1, 1, 8), (3, 2, 8), (2, 5, 4), (4, 3, 4)])
def test_shift_mask_is_scunet_generate_mask(hw, ww, p):
    got = k7.shift_mask(hw * p, ww * p, p, "cpu")
    assert torch.equal(got, REF.generate_mask(hw, ww, p, p // 2, "cpu"))


def test_sw_mask_and_roll_change_the_last_windows_only():
    """SW against W on the image rolled by hand: equal in every window but
    the last row and column of windows, where the mask cuts the wrap; a
    mask on the wrong side or a roll the wrong way fails here."""
    g = torch.Generator().manual_seed(5)
    p, C, heads = 4, 16, 2
    qkv = torch.randn((1, 12, 16, 3 * C), generator=g)
    bias = k7.relative_bias(torch.randn((heads, 2 * p - 1, 2 * p - 1), generator=g), p)
    sw = k7.window_attention(qkv, bias, heads, p, True)
    rolled = torch.roll(qkv, shifts=(-(p // 2), -(p // 2)), dims=(1, 2))
    w = torch.roll(k7.window_attention(rolled, bias, heads, p, False),
                   shifts=(p // 2, p // 2), dims=(1, 2))
    inner = (slice(None), slice(p // 2, 12 - p // 2 - 2), slice(p // 2, 16 - p // 2 - 2))
    torch.testing.assert_close(sw[inner], w[inner], rtol=0, atol=1e-6)
    assert not torch.allclose(sw, w, atol=1e-3)


def test_plain_calls_are_not_launches():
    before = dict(k7.WINDOW_ATTN_STATS)
    qkv = torch.zeros((1, 8, 8, 48))
    k7.window_attention(qkv, torch.zeros((2, 16, 16)), 2, 4, True)
    assert k7.WINDOW_ATTN_STATS == before
    with pytest.raises(ValueError, match="whole number"):
        k7.window_attention(torch.zeros((1, 6, 8, 48)), torch.zeros((2, 16, 16)), 2, 4, False)


# -- the model's stages against the reference ---------------------------------

@pytest.mark.parametrize("window", [8, 4])
def test_stages_match_the_reference(setup, window):
    """g_a, h_a, h_mean_s and h_scale_s, each slice's means, scales and
    y_hat, and g_s, each fed the reference's own input; windows of 8 (4 in
    the hyper transforms) and of 4 throughout."""
    cfg, W, model, ref = setup if window == 8 else _build(window)
    x = _photo(128, 128, 64, 200)
    with torch.no_grad():
        y, z = model.analysis(x)
        yr = ref.g_a(x.permute(0, 3, 1, 2))
        _close(y.permute(0, 3, 1, 2), yr, "g_a")
        zr = ref.h_a(yr)
        _close(z.permute(0, 3, 1, 2), zr, "h_a")
        med = model.eb_medians()
        z_hat = (torch.round(zr - med[None, :, None, None]) + med[None, :, None, None])
        means, scales = model.hyper_synthesis(z_hat.permute(0, 2, 3, 1))
        _close(means.permute(0, 3, 1, 2), ref.h_s("h_mean_s", z_hat), "h_mean_s")
        _close(scales.permute(0, 3, 1, 2), ref.h_s("h_scale_s", z_hat), "h_scale_s")
        z_sym = torch.round(zr - med[None, :, None, None]).to(torch.int16).permute(0, 2, 3, 1)
        # any symbols will do: both chains take the same
        syms = [torch.round(s).to(torch.int16).permute(0, 2, 3, 1)
                for s in torch.split(yr, model.slice_channels, dim=1)]
        y_hat_ref, params = ref.chain(z_sym, lambda i, _m: syms[i])
        y_hat = []
        for i in range(model.slices):
            ms, mu, sigma = model.slice_params(i, means, scales, y_hat)
            _close(mu.permute(0, 3, 1, 2), params[i][0], f"means {i}")
            _close(sigma.permute(0, 3, 1, 2), params[i][1], f"scales {i}")
            y_hat.append(model.slice_refine(i, ms, syms[i].float() + mu))
            _close(y_hat[-1].permute(0, 3, 1, 2), y_hat_ref[i], f"y_hat {i}")
        x_hat = model.synthesis(torch.cat(y_hat_ref, dim=1).permute(0, 2, 3, 1))
        _close(x_hat.permute(0, 3, 1, 2), ref.g_s(torch.cat(y_hat_ref, dim=1)), "g_s")


@pytest.mark.parametrize("h,w", [(128, 128), (100, 70)])
def test_roundtrip_matches_the_reference(setup, h, w):
    """compress -> decompress on the device coder's plain kernels: decoded
    symbols equal the coded, equal the reference's encode; x_hat matches the
    reference's decode of the same symbols. 100x70 pads to 128x128."""
    cfg, W, model, ref = setup
    codec = TcmCodec(copy.deepcopy(model), coder="device", device="cpu")
    codec.update()
    x = _photo(h, w, 40, 90)
    comp = codec.compress(x)
    dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
    coded = [torch.as_tensor(s) for s in comp["symbols"]]
    decoded = [torch.as_tensor(s) for s in dec["symbols"]]
    assert len(coded) == 1 + model.slices
    for a, b in zip(coded, decoded):
        assert torch.equal(a.to(torch.int32), b.to(torch.int32))
    with torch.no_grad():
        e = ref.encode(x)
        for a, b in zip(e["symbols"], coded):
            assert torch.equal(a.to(torch.int32), b.to(torch.int32))
        want = ref.decode(decoded, h, w)
    assert dec["x_hat"].shape == (1, h, w, 3)
    _close(dec["x_hat"], want, "x_hat")


def test_forward_likelihoods_follow_the_chain(setup):
    """The training forward without noise: its y likelihoods are the
    Gaussian likelihoods of the rounded latents under the chain's means and
    scales (the reference's), and its x_hat is g_s of the chain's y_hat."""
    from hyres_tpu_torch.entropy import gaussian_likelihood

    cfg, W, model, ref = setup
    x = _photo(128, 128, 0, 0)
    with torch.no_grad():
        out = model(x)
        e = ref.encode(x)
        y_hat, params = ref.chain(e["symbols"][0], lambda i, _m: e["symbols"][i + 1])
        lik = torch.cat([gaussian_likelihood(s.permute(0, 3, 1, 2).float() + mu, sg, mu)
                         for s, (mu, sg) in zip(e["symbols"][1:], params)], dim=1)
        _close(out["likelihoods"]["y"].permute(0, 3, 1, 2), lik, "y likelihoods")
        _close(out["x_hat"].permute(0, 3, 1, 2), ref.g_s(torch.cat(y_hat, dim=1)), "x_hat")
        noise = model.draw_noise(x.shape, torch.Generator().manual_seed(3), "cpu")
        noisy = model(x, noise)
    assert noisy["likelihoods"]["y"].shape == out["likelihoods"]["y"].shape
    assert not torch.equal(noisy["likelihoods"]["y"], out["likelihoods"]["y"])
