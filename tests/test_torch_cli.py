"""The port's file formats and CLIs against JAX's.

- msgpack: ``packb`` equals ``msgpack.packb(obj, use_bin_type=True)``, and
  ``save_checkpoint`` equals flax's ``msgpack_serialize`` (and the JAX
  package's ``save_checkpoint``) byte for byte on a seeded tree;
- HYC1: bytes equal to JAX's ``pack_compressed`` for the same compress()
  dict; each package reads the other's .hyc; a ``"tpu"`` container
  decodes with the port's device coder;
- ``cli.codec``: a .hyc from either package decodes in the other to a PNG
  within 0.02 dB of the encoding package's own decode;
- ``cli.inference``: single, ``--batch 2`` and ``--stream 2`` rows agree
  (stream exact, batch within 1e-6 relative: batch-2 convolutions sum in
  another order), with JAX's ``metrics.csv`` columns;
- ``cli.updata``: JAX reads the artifact; refit quantiles within 1e-4 of
  JAX's; tables equal to JAX's ``updata`` except where a refit a few ulps
  away moves the bottleneck bake (bounded below);
- ``ms_ssim`` and ``psnr`` within 1e-5 of JAX's on seeded 256x256 images;
- ``save_image`` read back equal by ``read_png`` and by PIL;
- no module of the port imports JAX, flax, msgpack, PIL or ``hyres_tpu``.

The trained artifact runs at full width (N=128, M=192, q=1) on 64x64
crops, float32 on the CPU.
"""

import ast
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from hyres_tpu.coding import container as jcontainer
from hyres_tpu.losses import metrics as jmetrics
from hyres_tpu.train import checkpoint as jckpt
from hyres_tpu_torch.cli import codec as tcli_codec
from hyres_tpu_torch.cli import inference as tcli_inf
from hyres_tpu_torch.cli import updata as tcli_updata
from hyres_tpu_torch.coding import container as tcontainer
from hyres_tpu_torch.losses import ms_ssim, psnr
from hyres_tpu_torch.models import hyres as thyres
from hyres_tpu_torch.train import checkpoint as tckpt
from hyres_tpu_torch.utils import flax_msgpack
from hyres_tpu_torch.utils.png import load_image, read_png, save_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = str(ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack")
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
JAX_COLUMNS = ["filename", "total_bpp", "jpeg_bpp", "y_bpp", "z_bpp", "mse", "psnr",
               "ms_ssim", "enc_time", "dec_time"]


def _crop(i, j, size=64):
    return np.array(load_image(IMAGE)[:, i: i + size, j: j + size])


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(1 / mse)


def _png01(path):
    return read_png(path).astype(np.float64) / 255.0


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Three 64x64 PNG crops of the in-repo image in one directory."""
    d = tmp_path_factory.mktemp("images")
    for k, (i, j) in enumerate(((0, 0), (192, 320), (384, 128))):
        save_image(_crop(i, j), d / f"img{k}.png")
    return d


def _tree(rng):
    return {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                                "bias": np.zeros(8, np.float32)},
                       "eb": {"quantiles": rng.normal(size=(8, 1, 3)).astype(np.float32)}},
            "tables": {"cdf": rng.integers(0, 65536, (4, 40)).astype(np.int32),
                       "big": rng.normal(size=(70000,)).astype(np.float32)},
            "step": np.int64(7), "lr": np.float32(1e-4),
            "config": {"N": 16, "name": "a" * 40, "flag": True, "none": None,
                       "neg": -70000, "f": 0.25, "blob": b"\x00" * 300}}


def test_packb_and_save_checkpoint_equal_msgpack_and_flax(tmp_path):
    tree = _tree(np.random.default_rng(3))
    want = msgpack.packb(tree, use_bin_type=True, default=serialization._msgpack_ext_pack)
    assert flax_msgpack.packb(tree) == want
    flax_msgpack.save_checkpoint(tree, tmp_path / "a.msgpack")
    assert (tmp_path / "a.msgpack").read_bytes() == serialization.msgpack_serialize(tree)
    assert not (tmp_path / "a.msgpack.tmp").exists()
    back = flax_msgpack.load_checkpoint(tmp_path / "a.msgpack")
    np.testing.assert_array_equal(back["tables"]["big"], tree["tables"]["big"])
    # the training-checkpoint writers of both packages, on a tree with lists
    # and Python scalars
    ck = {"epoch": 3, "loss": 1.5, "params": tree["params"], "hist": [1, 2.0]}
    jckpt.save_checkpoint(ck, tmp_path / "j.msgpack")
    tckpt.save_checkpoint(ck, tmp_path / "t.msgpack")
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()


@pytest.fixture(scope="module")
def device_comp():
    codec = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")
    x = _crop(64, 64)
    comp = codec.compress(torch.from_numpy(x))
    return codec, x, comp


def test_hyc_bytes_equal_jax_and_cross_read(device_comp):
    codec, _, comp = device_comp
    blob = tcontainer.pack_compressed(comp, model="hyres", N=128, M=192,
                                      jpeg_quality=1, coder="device")
    jblob = jcontainer.pack_compressed(
        {k: comp[k] for k in ("strings", "shape", "size", "jpeg_buffers")},
        model="hyres", N=128, M=192, jpeg_quality=1, coder="tpu")
    assert blob == jblob
    jdoc = jcontainer.unpack_compressed(blob)
    tdoc = tcontainer.unpack_compressed(jblob)
    assert jdoc["coder"] == tdoc["coder"] == "tpu"
    assert tcontainer.coder_for_container(tdoc["coder"]) == "device"
    for doc in (jdoc, tdoc):
        assert doc["payload"]["shape"] == comp["shape"]
        assert doc["payload"]["size"] == comp["size"]
        assert doc["payload"]["strings"] == comp["strings"]
    dec = codec.decompress(tdoc["payload"])
    for got, coded in zip(dec["symbols"], comp["symbols"]):
        assert torch.equal(got, coded)


def test_hyc_rejects_bad_magic_and_version():
    good = tcontainer.pack_compressed({"strings": [], "shape": (1, 1)}, model="hyres",
                                      N=1, M=1)
    with pytest.raises(ValueError, match="HYC1"):
        tcontainer.unpack_compressed(b"HYC0" + good[4:])
    bad = jcontainer.MAGIC + msgpack.packb({"version": 2, "payload": {}}, use_bin_type=True)
    with pytest.raises(ValueError, match="version"):
        tcontainer.unpack_compressed(bad)
    with pytest.raises(ValueError, match="coder"):
        tcontainer.coder_for_container("gpu")


def test_codec_cli_cross_decodes(images, tmp_path):
    """port encode -> JAX decode, and JAX encode -> port decode (device /
    tpu coder), each PNG within 0.02 dB of the encoder package's own."""
    from hyres_tpu.cli import codec as jcli_codec

    src = images / "img1.png"
    x = _png01(src)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tcli_codec.main(["encode", "--checkpoint", ARTIFACT, "--coder", "device",
                     "--device", "cpu", str(src), "-o", str(tdir)])
    jcli_codec.main(["encode", "--checkpoint", ARTIFACT, "--coder", "tpu", str(src),
                     "-o", str(jdir)])
    assert tcontainer.unpack_compressed((tdir / "img1.hyc").read_bytes())["coder"] == "tpu"
    outs = {}
    for enc_dir in (tdir, jdir):
        for name, main in (("t", tcli_codec.main), ("j", jcli_codec.main)):
            out = tmp_path / f"{enc_dir.name}{name}"
            argv = ["decode", "--checkpoint", ARTIFACT, str(enc_dir / "img1.hyc"),
                    "-o", str(out)]
            main(argv + (["--device", "cpu"] if name == "t" else []))
            outs[enc_dir.name + name] = _psnr(_png01(out / "img1.png"), x)
    assert abs(outs["tj"] - outs["tt"]) <= 0.02, outs
    assert abs(outs["jt"] - outs["jj"]) <= 0.02, outs


def test_codec_cli_checkerboard_on_seeded_params(images, tmp_path):
    """--model checkerboard on small seeded parameters, host coder. From the
    raw checkpoint each package refits and bakes its own tables, which may
    differ in a row (``test_updata_cli_matches_jax``), so the cross-package
    check runs on an artifact baked by the port's updata: both packages
    then write the same .hyc and decode it to the same PNG."""
    from hyres_tpu.cli import codec as jcli_codec
    from hyres_tpu.models.checkerboard import LightWeightCheckerboard

    params = LightWeightCheckerboard(16, 24).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), noisequant=True, rng=jax.random.key(1))
    ckpt = tmp_path / "cb.msgpack"
    jckpt.save_checkpoint({"epoch": 0, "params": params}, ckpt)
    src = str(images / "img0.png")
    enc = ["encode", "--model", "checkerboard", "--N", "16", "--M", "24"]
    tcli_codec.main([*enc, "--checkpoint", str(ckpt), "--device", "cpu", src,
                     "-o", str(tmp_path / "raw")])
    tcli_codec.main(["decode", "--checkpoint", str(ckpt), "--device", "cpu",
                     str(tmp_path / "raw" / "img0.hyc"), "-o", str(tmp_path / "raw")])
    assert read_png(tmp_path / "raw" / "img0.png").shape == (64, 64, 3)

    tcli_updata.main(["--filepath", str(ckpt), "--name", "cb_art", "--dir", str(tmp_path),
                      "--N", "16", "--M", "24"])
    art = ["--checkpoint", str(tmp_path / "cb_art.msgpack")]
    tcli_codec.main([*enc, *art, "--device", "cpu", src, "-o", str(tmp_path / "t")])
    jcli_codec.main([*enc, *art, src, "-o", str(tmp_path / "j")])
    blob = (tmp_path / "t" / "img0.hyc").read_bytes()
    assert blob == (tmp_path / "j" / "img0.hyc").read_bytes()
    tcli_codec.main(["decode", *art, "--device", "cpu", str(tmp_path / "t" / "img0.hyc"),
                     "-o", str(tmp_path / "td")])
    jcli_codec.main(["decode", *art, str(tmp_path / "t" / "img0.hyc"), "-o", str(tmp_path / "jd")])
    np.testing.assert_array_equal(read_png(tmp_path / "td" / "img0.png"),
                                  read_png(tmp_path / "jd" / "img0.png"))


def test_cli_refuses_unported_families(images, tmp_path):
    for model in ("elic", "cheng2020"):
        with pytest.raises(SystemExit, match="queue 1, item 2"):
            tcli_inf.main(["--checkpoint", ARTIFACT, "--input", str(images), "--output",
                           str(tmp_path), "--model", model, "--device", "cpu"])


def _rows(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return rows


def test_inference_cli_modes_agree(images, tmp_path):
    base = ["--checkpoint", ARTIFACT, "--input", str(images), "--coder", "device",
            "--device", "cpu", "--cold-timings"]
    runs = {}
    for name, extra in (("single", []), ("batch", ["--batch", "2"]),
                        ("stream", ["--stream", "2"])):
        out = tmp_path / name
        tcli_inf.main(base + ["--output", str(out)] + extra)
        rows = _rows(out / "metrics.csv")
        assert list(rows[0]) == JAX_COLUMNS
        assert [r["filename"] for r in rows] == ["img0.png", "img1.png", "img2.png",
                                                 "average", "median"]
        assert (out / "fallbacks.txt").read_text().startswith("host_fallbacks=0")
        assert (out / "img0_recon.png").exists()
        runs[name] = {r["filename"]: r for r in rows}
    for f in ("img0.png", "img1.png", "img2.png"):
        one = runs["single"][f]
        assert runs["stream"][f]["total_bpp"] == one["total_bpp"]
        assert runs["stream"][f]["psnr"] == one["psnr"]
        assert runs["batch"][f]["total_bpp"] == one["total_bpp"]
        assert float(runs["batch"][f]["psnr"]) == pytest.approx(float(one["psnr"]), rel=1e-6)
    avg = np.mean([float(runs["single"][f]["total_bpp"]) for f in ("img0.png", "img1.png",
                                                                    "img2.png")])
    assert float(runs["single"]["average"]["total_bpp"]) == pytest.approx(avg)


def test_inference_cli_save_components(images, tmp_path):
    tcli_inf.main(["--checkpoint", ARTIFACT, "--input", str(images / "img2.png"),
                   "--output", str(tmp_path), "--device", "cpu", "--cold-timings",
                   "--save-components"])
    for part in ("recon", "jpeg", "residual"):
        assert read_png(tmp_path / f"img2_{part}.png").shape == (64, 64, 3)


@pytest.fixture(scope="module")
def jax_train_checkpoint(tmp_path_factory):
    """A JAX training checkpoint at N=16/M=24/q=10, as tests/test_cli.py
    makes one."""
    from hyres_tpu.models.hyres import ResidualJPEGCompression

    d = tmp_path_factory.mktemp("updata")
    model = ResidualJPEGCompression(N=16, M=24, jpeg_quality=10)
    params = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                        noisequant=True, rng=jax.random.key(1))
    jckpt.save_checkpoint({"epoch": 0, "params": params, "loss": 1.0}, d / "train.msgpack")
    return d


def test_updata_cli_matches_jax(jax_train_checkpoint):
    """The refit quantiles of the two packages differ by a few ulps (the
    CDF logit sums in another order); in this checkpoint one of the 16
    bottleneck rows then bakes differently: its escape bin takes 1 of 65536
    against JAX's 72, and 275 of its 433 CDF entries move, by at most 856.
    Here a bake of equal quantiles is equal: the port's tables equal JAX's
    bake of the port's quantiles."""
    from hyres_tpu.cli.updata import main as jupdata
    from hyres_tpu.entropy import build_bottleneck_tables as jbake
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    d = jax_train_checkpoint
    argv = ["--filepath", str(d / "train.msgpack"), "--dir", str(d), "--N", "16",
            "--M", "24", "--jpeg-quality", "10"]
    jupdata(argv + ["--name", "jax"])
    tcli_updata.main(argv + ["--name", "port"])
    j = jckpt.load_checkpoint(d / "jax.msgpack")
    t = jckpt.load_checkpoint(d / "port.msgpack")
    config, params, tables = load_artifact(d / "port.msgpack")
    assert config == {"N": 16, "M": 24, "jpeg_quality": 10}
    assert set(t) == set(j) == {"params", "tables", "config"}
    eb_j = j["params"]["residual_model"]["entropy_bottleneck"]
    eb_t = t["params"]["residual_model"]["entropy_bottleneck"]
    np.testing.assert_allclose(eb_t["quantiles"], eb_j["quantiles"], atol=1e-4, rtol=0)
    for k in j["tables"]["gaussian"]:
        np.testing.assert_array_equal(t["tables"]["gaussian"][k], j["tables"]["gaussian"][k])
    tb, jb = t["tables"]["bottleneck"], j["tables"]["bottleneck"]
    for k in ("cdf_length", "offset"):
        np.testing.assert_array_equal(tb[k], jb[k])
    diff = np.abs(tb["quantized_cdf"].astype(np.int64) - jb["quantized_cdf"])
    assert len(np.unique(np.nonzero(diff)[0])) <= 1
    assert np.count_nonzero(diff) <= 275 and diff.max() <= 856
    np.testing.assert_array_equal(tb["quantized_cdf"], jbake(eb_t).quantized_cdf)
    np.testing.assert_array_equal(tables["bottleneck"]["quantized_cdf"], tb["quantized_cdf"])


def test_metrics_match_jax():
    rng = np.random.default_rng(11)
    x = rng.random((2, 256, 256, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert abs(float(ms_ssim(xt, yt)) - float(jmetrics.ms_ssim(jnp.asarray(x), jnp.asarray(y)))) <= 1e-5
    assert abs(float(psnr(xt, yt)) - float(jmetrics.psnr(jnp.asarray(x), jnp.asarray(y)))) <= 1e-5
    assert float(ms_ssim(xt, xt)) == pytest.approx(1.0, abs=1e-6)


def test_save_image_reads_back(tmp_path):
    x = np.random.default_rng(4).random((1, 37, 53, 3)).astype(np.float32)
    x[0, 0, :3] = [-0.2, 1.3, 0.998]
    save_image(torch.from_numpy(x), tmp_path / "a.png")
    want = np.clip(x[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), want)


FORBIDDEN = {"jax", "flax", "optax", "msgpack", "PIL", "hyres_tpu"}


def _pil_codec_method_imports(tree) -> set:
    """The import statements inside ``PilJpegCodec``'s methods: the one
    place where the port may import PIL (the card's machine has none, so
    only calling the PIL codec needs it)."""
    return {id(n) for c in ast.walk(tree)
            if isinstance(c, ast.ClassDef) and c.name == "PilJpegCodec"
            for f in c.body if isinstance(f, ast.FunctionDef)
            for n in ast.walk(f) if isinstance(n, (ast.Import, ast.ImportFrom))}


def test_port_imports_no_jax_flax_msgpack_pil():
    files = sorted((ROOT / "hyres_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        pil_ok = _pil_codec_method_imports(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] == "PIL" and id(node) in pil_ok:
                    continue
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
