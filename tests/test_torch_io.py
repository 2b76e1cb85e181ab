"""Port's stdlib readers (flax msgpack, PNG) and its import boundary.

The msgpack reader must give every array of the trained artifact
bit-identical to flax.serialization.msgpack_restore, with the same tree;
the PNG reader must give PIL's pixels exactly. The port and chip_smoke.py
must import nothing of jax, flax, msgpack, PIL or hyres_tpu.
"""

import ast
import struct
import zlib
from pathlib import Path

import flax.serialization
import msgpack
import numpy as np
import pytest
from PIL import Image

from hyres_tpu_torch.utils import flax_msgpack, png

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "PIL", "hyres_tpu"}


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray), path
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def test_artifact_matches_flax_restore():
    data = ARTIFACT.read_bytes()
    _assert_same_tree(flax_msgpack.unpackb(data),
                      flax.serialization.msgpack_restore(data))
    config, params, tables = flax_msgpack.load_artifact(ARTIFACT)
    assert config == {"N": 128, "M": 192, "jpeg_quality": 1}
    assert set(params) == {"residual_model", "refine"}
    assert set(tables) == {"gaussian", "bottleneck"}


def test_msgpack_scalars_and_containers():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.5, -1.25e300],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "flags": [None, True, False],
        "big": list(range(20)),
        "map": {f"k{i}": i for i in range(20)},
    }
    assert flax_msgpack.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj
    arr = np.arange(12, dtype=np.int64).reshape(3, 4)
    packed = flax.serialization.msgpack_serialize({"a": arr, "f": np.float32(2.5)})
    got = flax_msgpack.unpackb(packed)
    np.testing.assert_array_equal(got["a"], arr)
    assert got["a"].dtype == np.int64
    assert got["f"] == np.float32(2.5) and got["f"].dtype == np.float32
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(packed[:-3])


def test_png_matches_pil():
    got = png.read_png(IMAGE)
    want = np.asarray(Image.open(IMAGE).convert("RGB"))
    assert got.shape == (768, 512, 3)
    np.testing.assert_array_equal(got, want)
    x = png.load_image(IMAGE)
    assert x.shape == (1, 768, 512, 3) and x.dtype == np.float32


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prior, bpp=3):
    out = bytearray(len(row))
    for j in range(len(row)):
        a = row[j - bpp] if j >= bpp else 0
        b = prior[j]
        c = prior[j - bpp] if j >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
        out[j] = (row[j] - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def test_png_all_filter_types(tmp_path, rng_np):
    """Rows filtered with each of the five PNG filters decode exactly."""
    h, w = 10, 7
    img = rng_np.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rows, prior = [], bytes(w * 3)
    for i in range(h):
        row = img[i].tobytes()
        rows.append(_filter_row(i % 5, row, prior))
        prior = row
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))
    path = tmp_path / "filters.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_rejects_unsupported(tmp_path):
    path = tmp_path / "gray.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)
    with pytest.raises(ValueError, match="RGB"):
        png.read_png(path)


def _imports(path: Path):
    """Module names a file imports, except PIL inside ``PilJpegCodec``'s
    methods: the one place where the port may import it (the card's
    machine has none, so only calling the PIL codec needs it)."""
    tree = ast.parse(path.read_text(), str(path))
    pil_codec = {id(n) for c in ast.walk(tree)
                 if isinstance(c, ast.ClassDef) and c.name == "PilJpegCodec"
                 for f in c.body if isinstance(f, ast.FunctionDef)
                 for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if not (name.split(".")[0] == "PIL" and id(node) in pil_codec):
                yield name


def test_port_imports_no_jax_flax_msgpack_pil():
    files = sorted((ROOT / "hyres_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
