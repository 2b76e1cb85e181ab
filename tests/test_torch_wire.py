"""The device coder's wire (sliced pulls, column-sparse and sparse
coefficients, the sparse coefficient upload) against the JAX package's,
on the CPU.

``hyres_tpu_torch.models.codec`` (``_sizes_cols``, ``_pack_sliced``,
``_unpack_sliced_host``, ``pull_encs_dispatch``) and
``coding/device_rans.py masked_compact`` against
``hyres_tpu.models.codec`` and ``hyres_tpu.coding.tpu_rans``, whose XLA
lowering runs on the CPU. Both encoders give the same outputs on the
same symbols (``tests/test_torch_rans.py``), so every comparison is
exact: blobs and size rows byte for byte, ``cap_state`` and the
per-call ``WIRE_STATS`` counts equal. The codec level runs HyRES on a
128x128 crop of the trained artifact, JAX's ``coder="tpu"`` against the
port's ``coder="device"``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.coding import tpu_rans as tr
from hyres_tpu.entropy import get_scale_table
from hyres_tpu.entropy.bottleneck import CdfTables
from hyres_tpu.models import codec as jcodec
from hyres_tpu.models import hyres as jhyres
from hyres_tpu.train.checkpoint import extract_variables, load_checkpoint
from hyres_tpu_torch.coding import device_rans as dr
from hyres_tpu_torch.jpeg.core import coefs_from_bytes
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.models import hyres as thyres
from hyres_tpu_torch.utils.flax_msgpack import load_artifact
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N_Z, N_Y = 3000, 20000      # symbols of the factorized and the gaussian plane
NBLK = 40                   # 8x8 blocks of the coefficient payload


@pytest.fixture(scope="module")
def tables():
    """(JAX, port) gaussian segment tables and factorized tables of the
    trained artifact's bottleneck."""
    st = get_scale_table()
    b = load_artifact(ARTIFACT)[2]["bottleneck"]
    host = CdfTables(quantized_cdf=np.asarray(b["quantized_cdf"], np.int32),
                     cdf_length=np.asarray(b["cdf_length"], np.int32),
                     offset=np.asarray(b["offset"], np.int32))
    return {"gauss": (tr.build_gauss_tables(st), dr.build_gauss_tables(st)),
            "eb": (tr.build_device_tables(host), dr.build_device_tables(host))}


def _encs(tables, B, seed, escapes=True, scales=(0, 64)):
    """The encoder outputs of a factorized plane (32 lanes) and a gaussian
    plane (64 lanes) from seeded symbols: (JAX dicts, port dicts).
    ``scales``: the range of the gaussian plane's scale rows."""
    rng = np.random.default_rng(seed)
    ej = tables["eb"][0]
    C = ej.off_f32.shape[0]
    zidx = np.broadcast_to(np.arange(N_Z) % C, (B, N_Z)).astype(np.int32)
    off = np.asarray(ej.off_f32).astype(np.int64)[zidx]
    width = np.asarray(ej.maxv_f32).astype(np.int64)[zidx]
    zsym = (off + np.clip(np.round(rng.normal(width / 2, width / 6)), 0,
                          width - 1)).astype(np.int32)
    yidx = rng.integers(*scales, (B, N_Y)).astype(np.int32)
    ysym = np.round(rng.normal(0, get_scale_table()[yidx])).astype(np.int32)
    if escapes:
        zsym[:, 5:7] = [[off[0, 5] - 40, -31000]] * B
        ysym[:, :3] = [[20000, -25000, 31000]] * B
    jencs, tencs = [], []
    for kind, sym, idx, lanes in (("eb", zsym, zidx, 32), ("gauss", ysym, yidx, 64)):
        fn = tr.gauss_encode if kind == "gauss" else tr.rans_encode
        tab = tables[kind][0]
        jencs.append(jax.jit(jax.vmap(lambda s, i: fn(s, i, tab, lanes)))(
            jnp.asarray(sym), jnp.asarray(idx)))
        plane = dr.gauss_plane if kind == "gauss" else dr.eb_plane
        tencs.append(dr.encode([plane(torch.from_numpy(sym), torch.from_numpy(idx),
                                      tables[kind][1], lanes)])[0])
    return jencs, tencs


def _coefs(B, cols, dtype, seed, per_col=12):
    """(B, NBLK * 64) coefficients, nonzero only at the 8x8-block
    positions ``cols``."""
    rng = np.random.default_rng(seed)
    c = np.zeros((B, NBLK, 64), dtype)
    for i in range(B):
        for col in cols:
            c[i, rng.integers(0, NBLK, per_col), col] = rng.integers(1, 100, per_col)
    return c.reshape(B, NBLK * 64)


def _counted(stats, fn):
    """fn() with ``stats`` (a WIRE_STATS dict) reset; (result, syncs, bytes)."""
    stats.update(d2h_bytes=0, d2h_syncs=0, h2d_bytes=0)
    out = fn()
    return out, stats["d2h_syncs"], stats["d2h_bytes"]


def _assert_pulls_equal(jout, tout):
    (jencs, jx), (tencs, tx) = jout, tout
    for je, te in zip(jencs, tencs):
        assert je.keys() == te.keys()
        for k in je:
            np.testing.assert_array_equal(np.asarray(te[k]), np.asarray(je[k]), k)
    if jx is None:
        assert tx is None
    else:
        assert tx.dtype == jx.dtype
        np.testing.assert_array_equal(tx, jx)


# -- the pack, byte for byte ------------------------------------------------------


LAYOUTS = [("dense", np.int8), ("dense", np.int16), ("pairs", np.int8),
           ("pairs", np.int16), ("cols", np.int8), ("cols", np.int16)]
COLS = (0, 1, 8, 31, 63)  # bits 31 and 63 set the sign of each int32 word


@pytest.mark.parametrize("escapes", [True, False])
@pytest.mark.parametrize("layout,dtype", LAYOUTS)
def test_sliced_pack_and_sizes_identical_to_jax(tables, layout, dtype, escapes):
    B = 2
    jencs, tencs = _encs(tables, B, seed=3, escapes=escapes)
    extra = _coefs(B, COLS, dtype, seed=4)
    jx, tx = jnp.asarray(extra), torch.from_numpy(extra)

    sizes_j = np.asarray(jcodec._sizes_jit(jencs, jx))
    sizes_t = tcodec._sizes_cols(tencs, tx).numpy()
    np.testing.assert_array_equal(sizes_t, sizes_j)
    assert (sizes_t[:, -3] < 0).all() and (sizes_t[:, -2] < 0).all()  # the wrap
    assert sizes_t[0, -1] == np.count_nonzero(extra[0])

    caps = [int(e["stream"].shape[1]) for e in tencs]
    plans = tcodec._exact_plans(sizes_t, [32, 64], caps)
    assert plans == jcodec._exact_plans(sizes_j, [32, 64], caps)
    assert all(el == (dr.ESC_MAX if escapes else 0) for _, _, el in plans)
    slices = tuple((sl, el) for _, sl, el in plans)
    cap, cols = {"dense": (None, None), "pairs": (4096, None),
                 "cols": (None, COLS)}[layout]
    info = (np.dtype(dtype), NBLK * 64, cap) + ((cols,) if cols else ())
    for with_sizes in (True, False):
        blob_j = np.asarray(jcodec._pack_sliced_jit(
            jencs, jx, slices=slices, coef_cap=cap, with_sizes=with_sizes, coef_cols=cols))
        blob_t = tcodec._pack_sliced(tencs, tx, slices, cap, with_sizes=with_sizes,
                                     coef_cols=cols).numpy()
        assert blob_t.dtype == np.uint8 and blob_t.tobytes() == blob_j.tobytes()
        got = tcodec._unpack_sliced_host(blob_t, plans, info, with_sizes)
        want = jcodec._unpack_sliced_host(blob_j, plans, info, with_sizes)
        _assert_pulls_equal(want[:2], got[:2])
        np.testing.assert_array_equal(got[1], extra)
        if with_sizes:
            np.testing.assert_array_equal(got[2], sizes_j)


@pytest.mark.parametrize("cap", [16, 300])
def test_masked_compact_equals_jax(cap):
    """The device compaction: values in order, ``fill`` past the count,
    the count exact; at ``cap`` 16 the rows hold more than ``cap``."""
    rng = np.random.default_rng(cap)
    n = 500
    vals = rng.integers(-30000, 30000, (3, n)).astype(np.int16)
    mask = rng.random((3, n)) < np.array([[0.0], [0.1], [0.6]])
    iota = np.broadcast_to(np.arange(n, dtype=np.int32), (3, n))
    for v, fill in ((vals, 0), (iota, n)):
        want, wcount = jax.vmap(lambda a, m: tr.masked_compact(a, m, cap, fill=fill))(
            jnp.asarray(v), jnp.asarray(mask))
        got, count = dr.masked_compact(torch.from_numpy(v.copy()), torch.from_numpy(mask),
                                       cap, fill=fill)
        assert got.numpy().dtype == v.dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    assert count.numpy().max() > cap or cap == 300


# -- pull_encs_dispatch: the plans call by call ----------------------------------


def _pull_both(jencs, tencs, extra, jstate, tstate):
    """One pull on each side -> (JAX out, port out, per side (syncs, bytes))."""
    jx = None if extra is None else jnp.asarray(extra)
    tx = None if extra is None else torch.from_numpy(extra)
    jout, js, jb = _counted(jcodec.WIRE_STATS,
                            lambda: jcodec.pull_encs(jencs, jx, cap_state=jstate))
    tout, ts, tb = _counted(tcodec.WIRE_STATS,
                            lambda: tcodec.pull_encs_dispatch(tencs, tx, cap_state=tstate)())
    _assert_pulls_equal(jout, tout)
    assert tstate == jstate
    assert (ts, tb) == (js, jb)
    return ts, tb


def test_column_plan_sequence_equals_jax(tables):
    """JAX's own sequence (tests/test_tpu_rans.py, column-sparse path) at
    B=1: a full-cap pull that records the column mask, a speculative pull
    on the column plan, a new column that misses and re-pulls, and the
    widened plan again."""
    jencs, tencs = _encs(tables, 1, seed=11, escapes=False)
    jstate, tstate = {}, {}
    full = sum(4 * int(e["states"].shape[1]) + 8 + 8 * dr.ESC_MAX + 2 * int(e["stream"].shape[1])
               for e in tencs)
    runs = [_pull_both(jencs, tencs, _coefs(1, cols, np.int8, seed), jstate, tstate)
            for seed, cols in ((1, (0, 1, 8)), (2, (0, 8)), (3, (0, 1, 9)), (4, (1, 9)))]
    assert runs[0] == (1, full + NBLK * 64)
    assert runs[1][0] == 1 and runs[1][1] < full
    assert runs[2][0] == 2  # a new column: the speculative pull and a re-pull
    assert runs[3][0] == 1
    assert next(iter(tstate.values()))["colmask"] == (1 << 0) | (1 << 1) | (1 << 8) | (1 << 9)


@pytest.mark.parametrize("payload", ["cols", "pairs", "none"])
def test_two_phase_and_speculative_sequence_equals_jax(tables, payload):
    """B=2: a first call pulls the size rows, then an exactly sliced blob;
    the next is one speculative pull; streams past the high-water marks
    (wider scales) miss and re-pull. ``pairs``: a payload not 8x8-block
    aligned takes the (pos, val) plan, whose nonzeros then outgrow it."""
    jstate, tstate = {}, {}
    runs = []
    for seed, scales, nnz in ((1, (0, 20), 6), (2, (0, 20), 6), (3, (40, 64), 5000)):
        jencs, tencs = _encs(tables, 2, seed=seed, scales=scales)
        if payload == "none":
            extra = None
        elif payload == "cols":
            extra = _coefs(2, (0, 2, 63), np.int16, seed)
        else:  # not block-aligned, and dense beyond 6 bytes an entry of 4,096
            extra = np.zeros((2, 19997), np.int16)
            rng = np.random.default_rng(seed)
            extra[:, rng.integers(0, 19997, nnz)] = rng.integers(1, 500, nnz)
        runs.append(_pull_both(jencs, tencs, extra, jstate, tstate))
    assert [s for s, _ in runs] == [2, 1, 2]


def test_overflow_raises_from_finish(tables):
    """A plane over its escape list raises OverflowError from ``finish()``
    on the speculative plan and on the two-phase plan, as JAX's does."""
    jencs, tencs = _encs(tables, 2, seed=5)
    tstate, jstate = {}, {}
    tcodec.pull_encs_dispatch(tencs, cap_state=tstate)()
    jcodec.pull_encs(jencs, cap_state=jstate)
    tencs[1]["n_esc"] = torch.full_like(tencs[1]["n_esc"], 300)
    jencs[1] = dict(jencs[1], n_esc=jnp.full_like(jencs[1]["n_esc"], 300))
    for state in (tstate, {}):
        finish = tcodec.pull_encs_dispatch(tencs, cap_state=state)
        with pytest.raises(OverflowError, match="escapes"):
            finish()
    for state in (jstate, {}):
        with pytest.raises(OverflowError, match="escapes"):
            jcodec.pull_encs(jencs, cap_state=state)


# -- the sparse coefficient upload -----------------------------------------------


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_sparse_upload_scatters_to_the_dense_planes(dtype):
    shapes = [(4, 6, 8, 8), (2, 3, 8, 8), (2, 3, 8, 8)]
    n = sum(int(np.prod(s)) for s in shapes)
    rng = np.random.default_rng(0)
    flat = np.zeros((2, n), dtype)
    flat[0, rng.integers(0, n, 20)] = rng.integers(-120, 120, 20)
    flat[1, rng.integers(0, n, 9)] = rng.integers(-120, 120, 9)
    dense = thyres.sparse_coef_bytes(flat.view(np.uint8), np.dtype(dtype))
    assert dense[1] is None  # 6 * 4096 entries exceed the dense plane
    shapes = [(32, 48, 8, 8), (16, 24, 8, 8), (16, 24, 8, 8)]
    n = sum(int(np.prod(s)) for s in shapes)
    flat = np.zeros((2, n), dtype)
    flat[0, rng.integers(0, n, 300)] = rng.integers(-120, 120, 300)
    flat[0, n - 1] = 7
    flat[1, :5] = 3
    u8, cap = thyres.sparse_coef_bytes(flat.view(np.uint8), np.dtype(dtype))
    assert cap == 4096 and u8.shape == (2, 6 * cap)
    pos = u8[:, :4 * cap].copy().view(np.int32)
    assert (pos[1, :5] == np.arange(5)).all() and (pos[1, 5:] == n).all()
    planes = coefs_from_bytes(torch.from_numpy(u8), np.dtype(dtype), shapes, cap)
    want = coefs_from_bytes(torch.from_numpy(flat.view(np.uint8)), np.dtype(dtype), shapes)
    for got, ref in zip(planes, want):
        assert got.dtype == torch.int16 and got.shape == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref.numpy().astype(np.int16))


# -- the codec: HyRES requests, call by call --------------------------------------


def test_hyres_wire_equals_jax_call_by_call():
    """Three compresses (the first full-cap, then speculative on the
    column plan) and their decompresses (sparse coefficients): per call
    the port's d2h syncs and bytes and h2d bytes equal JAX's
    ``coder="tpu"``, ``cap_state`` equals JAX's, the payloads are
    byte-identical and the decoded images agree."""
    img = load_image(IMAGE)
    crop = np.array(img[:, 256:384, 128:256])
    xs = [crop, crop[:, ::-1].copy(), np.array(img[:, 128:256, 384:512])]
    raw = load_checkpoint(str(ARTIFACT))
    jc = jhyres.HyresCodec(jhyres.ResidualJPEGCompression(N=128, M=192, jpeg_quality=1),
                           extract_variables(raw), coder="tpu")
    jc.install_tables(raw["tables"])
    tc = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")
    pulled = []
    for k, x in enumerate(xs):
        cj, js, jb = _counted(jcodec.WIRE_STATS, lambda: jc.compress(jnp.asarray(x)))
        ct, ts, tb = _counted(tcodec.WIRE_STATS, lambda: tc.compress(torch.from_numpy(x)))
        assert (ts, tb) == (js, jb), k
        assert ts == 1
        pulled.append(tb)
        assert tc._residual._enc_cap_state == jc._residual._enc_cap_state
        assert ct["jpeg_buffers"] == cj["jpeg_buffers"]
        assert ct["strings"] == cj["strings"]
        assert tcodec.WIRE_STATS["host_fallbacks"] == 0
        dj, _, _ = _counted(jcodec.WIRE_STATS, lambda: jc.decompress(cj))
        jh = jcodec.WIRE_STATS["h2d_bytes"]
        dt, _, _ = _counted(tcodec.WIRE_STATS, lambda: tc.decompress(ct))
        assert tcodec.WIRE_STATS["h2d_bytes"] == jh, k
        for got, coded in zip(dt["symbols"], ct["symbols"]):
            assert torch.equal(got, coded)
        np.testing.assert_allclose(dt["x_hat"].numpy(), np.asarray(dj["x_hat"]), atol=1e-4)
    # the speculative plan ships less than the first call's full caps
    assert max(pulled[1:]) < pulled[0]
    assert len(tc._residual._enc_cap_state) == 1
