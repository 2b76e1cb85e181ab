"""The port's ``JpegCodec`` and ``PilJpegCodec`` against hyres_tpu's (CPU).

The reference's JPEG runs as it does on the TPU, through its Pallas
K1/K2 in interpret mode (tests/test_torch_train.py ``jax_tpu_jpeg``; its
CPU path divides by q where the kernel multiplies by 1/q, so a .5 tie
can round apart). Bars, those of tests/test_torch_jpeg.py: JFIF bytes
and the rate exact; decodes within 1e-2/255 on the [0, 1] scale
(summation order of the IDCT). ``PilJpegCodec``: bytes, decode and bpp
exact (one libjpeg). Both modules import where PIL is missing.
"""

import functools
import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hyres_tpu import jpeg as jjpeg
from hyres_tpu.jpeg.pil import PilJpegCodec as JPil
from hyres_tpu_torch.jpeg import JpegCodec
from hyres_tpu_torch.jpeg.pil import PilJpegCodec
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
ATOL = 1e-2 / 255


@pytest.fixture
def jax_tpu_jpeg(monkeypatch):
    """The reference's JPEG path on its Pallas K1/K2 in interpret mode."""
    from hyres_tpu.kernels import dct as jdct

    monkeypatch.setenv("HYRES_DCT_KERNEL", "pallas")
    for name in ("fdct_quant_blocks", "dequant_idct_blocks"):
        monkeypatch.setattr(jdct, name, functools.partial(getattr(jdct, name), interpret=True))

    def run(fn, *args):
        with jax.disable_jit():
            return fn(*args)
    return run


def _batch(which: str) -> np.ndarray:
    img = load_image(IMAGE)
    if which == "real":
        crop = img[0, 200:328, 100:228]
        return np.stack([crop, crop[::-1, ::-1]]).astype(np.float32)
    rng = np.random.default_rng(5)
    base = np.kron(rng.random((2, 6, 5, 3)), np.ones((1, 9, 9, 1)))[:, :50, :42]
    return np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("quality", [1, 50])
@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_jpeg_codec_call_and_bytes_equal_jax(jax_tpu_jpeg, which, quality):
    x = _batch(which)
    jc = jjpeg.JpegCodec(quality)
    jdec, jbpp = jax_tpu_jpeg(jc, jnp.asarray(x))
    jbufs = jax_tpu_jpeg(jc.compress, jnp.asarray(x))
    tc = JpegCodec(quality, device="cpu")
    dec, bpp = tc(torch.from_numpy(x))
    assert bpp.dtype == torch.float32 and float(bpp) == float(jbpp)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=ATOL)
    bufs = tc.compress(torch.from_numpy(x))
    assert bufs == jbufs
    # the rate counts the scan's bits padded to a byte plus the fixed
    # header; the file adds a stuffed 0x00 after each 0xFF of the scan
    file_bpp = sum(len(b) for b in bufs) * 8.0 / (x.shape[0] * x.shape[1] * x.shape[2])
    assert file_bpp - 0.1 < float(bpp) <= file_bpp + 1e-6


@pytest.mark.parametrize("which", ["real", "synthetic"])
def test_each_package_decodes_the_others_bytes(which):
    x = _batch(which)
    jc, tc = jjpeg.JpegCodec(1), JpegCodec(1, device="cpu")
    jbufs = jc.compress(jnp.asarray(x))
    tbufs = tc.compress(torch.from_numpy(x))
    for bufs in (jbufs, tbufs):
        want = np.asarray(jc.decompress(bufs))
        got = tc.decompress(bufs).numpy()
        assert got.shape == want.shape == x.shape
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_decompress_groups_quant_tables_in_order():
    """Streams of two qualities in one call: each decoded with its own
    tables, in the buffers' order, as the reference's per-image loop."""
    x = _batch("real")
    bufs = [JpegCodec(q, device="cpu").compress(torch.from_numpy(x[i: i + 1]))[0]
            for i, q in ((0, 1), (1, 50), (0, 50), (1, 1))]
    want = np.asarray(jjpeg.JpegCodec(1).decompress(bufs))
    got = JpegCodec(1, device="cpu").decompress(bufs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    for i, b in enumerate(bufs):
        assert torch.equal(got[i], JpegCodec(1, device="cpu").decompress([b])[0])


@pytest.mark.parametrize("mode,kw", [("L", {}), ("RGB", {"subsampling": 0})])
def test_decompress_refuses_other_layouts(mode, kw):
    img = (_batch("real")[0] * 255).astype(np.uint8)
    bio = io.BytesIO()
    Image.fromarray(img).convert(mode).save(bio, "JPEG", quality=50, **kw)
    for codec in (jjpeg.JpegCodec(1), JpegCodec(1, device="cpu")):
        with pytest.raises(ValueError, match="only 3-component 4:2:0 streams"):
            codec.decompress([bio.getvalue()])


def test_jpeg_codec_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default codec would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JpegCodec(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PilJpegCodec(1)


@pytest.mark.parametrize("quality", [1, 50])
def test_pil_codec_equals_jax(quality):
    x = _batch("real")
    jc, tc = JPil(quality), PilJpegCodec(quality, device="cpu")
    jbufs = jc.compress(jnp.asarray(x))
    assert tc.compress(torch.from_numpy(x)) == jbufs
    np.testing.assert_array_equal(tc.decompress(jbufs).numpy(), np.asarray(jc.decompress(jbufs)))
    jdec, jbpp = jc(jnp.asarray(x))
    dec, bpp = tc(torch.from_numpy(x))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    assert bpp.dtype == torch.float32 and float(bpp) == float(jbpp)


def test_jpeg_modules_import_without_pil():
    """Where PIL is missing (the card's machine), both modules import, and
    the PIL codec raises ImportError only when it is used."""
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import hyres_tpu_torch.jpeg, hyres_tpu_torch.jpeg.pil as p\n"
        "c = p.PilJpegCodec(1, device='cpu')\n"
        "try:\n"
        "    c.decompress([b''])\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
