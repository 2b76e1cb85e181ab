"""Port's JPEG engine (hyres_tpu_torch.jpeg) vs hyres_tpu.jpeg.

Coefficients: at most 0.1% off by one (the DCT's .5 ties, as
tests/test_kernels.py:27-31). JFIF bytes and the parse: exact, since the
port compiles its own copy of the same C++. Decode: atol 1e-2/255 on the
[0, 1] scale (summation order of the IDCT, as tests/test_kernels.py:43).
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu import jpeg as jjpeg
from hyres_tpu_torch import jpeg
from hyres_tpu_torch.kernels import dct
from hyres_tpu_torch.utils.png import load_image

IMAGE = (Path(__file__).resolve().parent.parent / "matched_r5" / "hyres_found"
         / "best_images" / "0_original.png")


def _images(rng):
    """A crop of the in-repo image, and a smooth random image whose sides
    are not multiples of 16 (edge padding)."""
    real = load_image(IMAGE)[:, 200:328, 100:228]
    base = rng.random((1, 6, 5, 3))
    smooth = np.kron(base, np.ones((1, 9, 9, 1)))[:, :50, :42]
    noisy = np.clip(smooth + 0.05 * rng.standard_normal(smooth.shape), 0, 1)
    return {"real": real, "synthetic": noisy.astype(np.float32)}


def _assert_coef_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    mismatch = int(np.sum(got != want))
    assert mismatch <= 0.001 * got.size, f"{mismatch} coefficients differ"
    assert np.max(np.abs(got.astype(np.int64) - want)) <= 1


@pytest.mark.parametrize("quality", [1, 50])
@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_coefficients_match_jax(rng_np, which, quality):
    x = _images(rng_np)[which]
    want = jjpeg.encode_to_coefficients(jnp.asarray(x), quality)
    got = jpeg.encode_to_coefficients(torch.from_numpy(x), quality)
    for g, w in zip((got.y, got.cb, got.cr), (want.y, want.cb, want.cr)):
        _assert_coef_close(g.numpy(), w)
    assert (got.height, got.width) == x.shape[1:3]


@pytest.mark.parametrize("quality", [1, 50])
def test_jfif_bytes_and_parse_exact(rng_np, quality):
    x = _images(rng_np)["synthetic"]
    c = jjpeg.encode_to_coefficients(jnp.asarray(x), quality)
    h, w = x.shape[1:3]
    y, cb, cr = (np.asarray(a)[0] for a in (c.y, c.cb, c.cr))
    want = jjpeg.assemble_jfif(y, cb, cr, w, h, quality)
    got = jpeg.assemble_jfif(y, cb, cr, w, h, quality)
    assert got == want
    p = jpeg.ParsedJpeg(got)
    assert (p.width, p.height, p.ncomp) == (w, h, 3)
    assert p.sampling[0] == (2, 2)
    for k, plane in enumerate((y, cb, cr)):
        np.testing.assert_array_equal(p.coeffs[k], plane)
    qy, qc = jpeg.tables.quality_to_qtables(quality)
    np.testing.assert_array_equal(p.qtables[0], qy)
    np.testing.assert_array_equal(p.qtables[1], qc)


def test_corrupt_stream_raises():
    with pytest.raises(ValueError):
        jpeg.ParsedJpeg(b"\xff\xd8garbage")


@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_decode_matches_jax(rng_np, which):
    x = _images(rng_np)[which]
    h, w = x.shape[1:3]
    c = jjpeg.encode_to_coefficients(jnp.asarray(x), 1)
    planes = [np.array(a) for a in (c.y, c.cb, c.cr)]
    want = np.asarray(jjpeg.decode_from_coefficients(
        *(jnp.asarray(p) for p in planes), 1, h, w))
    got = jpeg.decode_from_coefficients(
        *(torch.from_numpy(p) for p in planes), 1, h, w).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-2 / 255)
    qy, qc = jpeg.tables.quality_to_qtables(1)
    got_q = jpeg.decode_with_qtables(*(torch.from_numpy(p) for p in planes),
                                     qy, qc, h, w).numpy()
    np.testing.assert_array_equal(got_q, got)


def test_color_and_subsampling_match_jax(rng_np):
    x = _images(rng_np)["real"]
    want = [np.array(p) for p in jjpeg.core.rgb_to_ycbcr(jnp.asarray(x))]
    got = [p.numpy() for p in jpeg.core.rgb_to_ycbcr(torch.from_numpy(x))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        jpeg.core.downsample_420(torch.from_numpy(want[1])).numpy(),
        np.asarray(jjpeg.core.downsample_420(jnp.asarray(want[1]))))
    np.testing.assert_allclose(
        jpeg.core.upsample_420(torch.from_numpy(want[2])).numpy(),
        np.asarray(jjpeg.core.upsample_420(jnp.asarray(want[2]))), atol=1e-4)
    rgb = jpeg.core.ycbcr_to_rgb(*(torch.from_numpy(w) for w in want)).numpy()
    np.testing.assert_allclose(
        rgb, np.asarray(jjpeg.core.ycbcr_to_rgb(*(jnp.asarray(w) for w in want))),
        atol=1e-6)


# -- the plane calls (one call for the three planes of a request) against
# JAX's encode_to_coefficients / decode_with_qtables -------------------------

SIZES = [(40, 56), (768, 512)]  # (H, W): a crop that pads, and the whole image


@functools.lru_cache(maxsize=None)
def _batch(B, size):
    """B crops (H, W) = size of the in-repo image (768 high, 512 wide), the
    second one rotated by 180 degrees, NHWC."""
    img = load_image(IMAGE)[0]
    h, w = size
    crops = [img[:h, :w], img[::-1, ::-1][:h, :w]][:B]
    return np.ascontiguousarray(np.stack(crops)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_coefs(B, size, quality):
    c = jjpeg.encode_to_coefficients(jnp.asarray(_batch(B, size)), quality)
    return tuple(np.asarray(a) for a in (c.y, c.cb, c.cr))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("B", [1, 2])
def test_plane_k1_matches_jax_encode(B, size):
    """fdct_quant_planes' plain version on the three planes against JAX's
    encode_to_coefficients, at the main path's quality and at 50."""
    x = torch.from_numpy(_batch(B, size))
    y, cb, cr = jpeg.core.rgb_to_ycbcr(jpeg.core.pad_to_multiple(x, 16))
    planes = [y, jpeg.core.downsample_420(cb), jpeg.core.downsample_420(cr)]
    for quality in (1, 50):
        qy, qc = jpeg.tables.quality_to_qtables(quality)
        got = dct.fdct_quant_planes_ref(planes, [qy, qc, qc])
        for g, w in zip(got, _jax_coefs(B, size, quality)):
            _assert_coef_close(g.numpy(), w)
        whole = jpeg.encode_to_coefficients(x, quality)
        for g, w in zip((whole.y, whole.cb, whole.cr), got):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("B", [1, 2])
def test_plane_k2_matches_jax_decode(B, size, dtype):
    """dequant_idct_planes' plain version, fed int8 (quality 1, as the
    decompress path's upload holds them), int16 or int32 (quality 50)
    coefficients, against JAX's decode_with_qtables."""
    quality = 1 if dtype == np.int8 else 50
    coefs = _jax_coefs(B, size, quality)
    assert all(np.array_equal(c.astype(dtype), c) for c in coefs)
    qy, qc = jpeg.tables.quality_to_qtables(quality)
    h, w = size
    want = np.asarray(jjpeg.decode_with_qtables(
        *(jnp.asarray(c) for c in coefs), jnp.asarray(qy), jnp.asarray(qc), h, w))
    planes = [torch.from_numpy(c.astype(dtype)) for c in coefs]
    got = jpeg.decode_with_qtables(*planes, qy, qc, h, w).numpy()
    assert got.shape == want.shape == (B, h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-2 / 255)
    pix = dct.dequant_idct_planes_ref(planes, [qy, qc, qc])
    for p, c in zip(pix, coefs):
        assert p.shape == (B, 8 * c.shape[1], 8 * c.shape[2]) and p.dtype == torch.float32
