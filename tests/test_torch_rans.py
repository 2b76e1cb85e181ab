"""The port's device rANS coder against the JAX package's, on the CPU.

``hyres_tpu_torch.coding.device_rans`` with the plain versions of K3/K4/K5
(``hyres_tpu_torch/kernels/rans.py``) against ``hyres_tpu.coding.tpu_rans``,
whose XLA lowering runs on the CPU and is pinned bit-identical to the
Pallas kernels by the JAX package's own tests. The coder's wire is exact
integer arithmetic, so every comparison is exact:

- the tables equal JAX's;
- the port's frames are byte-identical to ``frame_plane`` of JAX's
  encoder on the same (symbols, rows);
- each side decodes the other's frames to the exact symbols;
- ``OverflowError`` at 256 escapes, at a stream over its cap, and at an
  escape value outside i16.

Cases cover each lane tier (32-256) once, both plane kinds, batches of 1
and 3, ragged tails, escapes, and a factorized stream longer than K5's
shared-memory ring.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.coding import tpu_rans as tr
from hyres_tpu.entropy import build_gaussian_tables as jax_gaussian_tables
from hyres_tpu.entropy import get_scale_table
from hyres_tpu.entropy.bottleneck import CdfTables
from hyres_tpu_torch.coding import device_rans as dr
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.utils.flax_msgpack import load_artifact

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"


@pytest.fixture(scope="module")
def tables():
    """(JAX, port) gaussian segment tables and (JAX, port) factorized
    tables of the trained artifact's bottleneck (128 rows)."""
    st = get_scale_table()
    b = load_artifact(ARTIFACT)[2]["bottleneck"]
    host = CdfTables(quantized_cdf=np.asarray(b["quantized_cdf"], np.int32),
                     cdf_length=np.asarray(b["cdf_length"], np.int32),
                     offset=np.asarray(b["offset"], np.int32))
    return {"gauss": (tr.build_gauss_tables(st), dr.build_gauss_tables(st)),
            "eb": (tr.build_device_tables(host), dr.build_device_tables(host))}


def test_tables_equal_jax(tables):
    (gj, gp), (ej, ep) = tables["gauss"], tables["eb"]
    for got, want in ((gp.bounds, gj.bounds), (gp.params, gj.params),
                      (ep.bounds, ej.cdf_f32), (ep.start, ej.start_f32),
                      (ep.freq, ej.freq_f32), (ep.offset, ej.off_f32),
                      (ep.maxv, ej.maxv_f32)):
        np.testing.assert_array_equal(got.numpy().astype(np.float32),
                                      np.asarray(want))
    assert ep.pad_symbol == ej.pad_symbol


def _symbols(kind, B, n, tabs, rng):
    """(sym, idx) (B, n) int32 from seeded numpy, with a few escapes."""
    if kind == "gauss":
        st = get_scale_table()
        idx = rng.integers(0, 64, (B, n)).astype(np.int32)
        sym = np.round(rng.normal(0, st[idx])).astype(np.int32)
        sym[:, :3] = [[20000, -25000, 31000]] * B
    else:
        ej = tabs[0]
        C = ej.off_f32.shape[0]
        idx = np.broadcast_to(np.arange(n) % C, (B, n)).astype(np.int32)
        off = np.asarray(ej.off_f32).astype(np.int64)[idx]
        width = np.asarray(ej.maxv_f32).astype(np.int64)[idx]
        sym = (off + np.clip(np.round(rng.normal(width / 2, width / 6)), 0,
                             width - 1)).astype(np.int32)
        sym[:, 5:8] = [[off[0, 5] - 40, off[0, 6] + 900, -31000]] * B
    return sym, idx


def _jax_encode(kind, sym, idx, tabs, lanes):
    fn = tr.gauss_encode if kind == "gauss" else tr.rans_encode
    enc = jax.jit(jax.vmap(lambda s, i: fn(s, i, tabs[0], lanes)))(
        jnp.asarray(sym), jnp.asarray(idx))
    return jax.tree.map(np.asarray, enc)


def _frames(enc):
    """Per-image frames of an encoder output dict (numpy or torch)."""
    enc = {k: np.asarray(v) for k, v in enc.items()}
    return tcodec.DevicePlaneCoder.frames_from_enc(enc)


def _as_t(a: np.ndarray, dt) -> torch.Tensor:
    """(k,) numpy -> (1, k) tensor of the same bits as ``dt``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(dt))[None]


def _port_decode(kind, frame, idx_row, tabs, n):
    lanes, states, stream, esc_pos, esc_val = dr.unframe_plane(frame, n)
    fn = dr.gauss_decode if kind == "gauss" else dr.eb_decode
    got = fn(_as_t(stream, np.int16), _as_t(states, np.int32),
             _as_t(idx_row, np.int32), _as_t(esc_pos, np.int32),
             _as_t(esc_val, np.int32), tabs[1], lanes, n)
    return got[0].numpy()


def _jax_decode(kind, frame, idx_row, tabs, n):
    lanes, states, stream, esc_pos, esc_val = tr.unframe_plane(frame, n)
    fn = tr.gauss_decode if kind == "gauss" else tr.rans_decode
    got = jax.jit(fn, static_argnums=(6, 7))(
        jnp.asarray(stream), jnp.asarray(states), jnp.asarray(idx_row),
        jnp.asarray(esc_pos), jnp.asarray(esc_val), tabs[0], lanes, n)
    return np.asarray(got)


CASES = [  # (kind, lanes, B, n)
    ("gauss", 32, 1, 1000),
    ("gauss", 64, 3, 5000),
    ("gauss", 128, 1, 20000),
    ("gauss", 256, 1, 9001),
    ("eb", 32, 3, 3000),
    ("eb", 64, 1, 12000),
    ("eb", 128, 1, 7000),
    ("eb", 256, 1, 20000),
    # about 19,600 renorm words: longer than K5's 16,384-word stream ring
    # on the card, whose tests compare K5 with the plain version held here
    ("eb", 64, 1, 40000),
]


@pytest.mark.parametrize("kind,lanes,B,n", CASES)
def test_frames_identical_and_cross_decode(tables, kind, lanes, B, n):
    tabs = tables[kind]
    rng = np.random.default_rng(lanes * 7 + n)
    sym, idx = _symbols(kind, B, n, tabs, rng)
    plane = dr.gauss_plane if kind == "gauss" else dr.eb_plane
    (enc,) = dr.encode([plane(torch.from_numpy(sym), torch.from_numpy(idx),
                              tabs[1], lanes)])
    ours = _frames({k: v.numpy() for k, v in enc.items()})
    theirs = _frames(_jax_encode(kind, sym, idx, tabs, lanes))
    assert ours == theirs
    assert int(enc["n_esc"].min()) >= 3
    for b in range(B):
        np.testing.assert_array_equal(
            _port_decode(kind, theirs[b], idx[b], tabs, n), sym[b])
    np.testing.assert_array_equal(
        _jax_decode(kind, ours[0], idx[0], tabs, n), sym[0])


def test_fused_encode_equals_separate_encodes(tables):
    """One launch of ragged planes (both kinds, lanes 32 and 64) gives the
    same outputs as one launch per plane."""
    rng = np.random.default_rng(9)
    specs = [("eb", 32, 2, 700), ("gauss", 64, 2, 3000), ("gauss", 32, 1, 64)]
    jobs = []
    for kind, lanes, B, n in specs:
        sym, idx = _symbols(kind, B, n, tables[kind], rng)
        plane = dr.gauss_plane if kind == "gauss" else dr.eb_plane
        jobs.append(plane(torch.from_numpy(sym), torch.from_numpy(idx),
                          tables[kind][1], lanes))
    fused = dr.encode(jobs)
    for job, got in zip(jobs, fused):
        (want,) = dr.encode([job])
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_escape_count_exactly_256_overflows():
    """n_esc == 256 fits the side list but not the one-byte header field:
    OverflowError (host-coder fallback), as in JAX."""
    host = jax_gaussian_tables(get_scale_table())
    t = dr.build_device_tables(host)
    n = 4096
    sym = np.zeros((1, n), np.int32)
    sym[0, :256] = 20000
    (enc,) = dr.encode([dr.eb_plane(torch.from_numpy(sym),
                                    torch.zeros((1, n), dtype=torch.int32), t, 64)])
    assert int(enc["n_esc"][0]) == 256
    np.testing.assert_array_equal(enc["esc_pos"][0].numpy(), np.arange(256))
    with pytest.raises(OverflowError, match="escapes"):
        _frames({k: v.numpy() for k, v in enc.items()})


def test_stream_over_cap_overflows(tables):
    """A plane above 65536 symbols gets an average-4-bits stream cap; wide
    uniform symbols exceed it: OverflowError at framing, and the buffer
    holds the last cap words in read order."""
    gp = tables["gauss"][1]
    n, lanes = 70000, 64
    rng = np.random.default_rng(4)
    idx = np.full((1, n), 63, np.int32)          # sigma 256
    sym = rng.integers(-1500, 1500, (1, n)).astype(np.int32)
    job = dr.gauss_plane(torch.from_numpy(sym), torch.from_numpy(idx), gp, lanes)
    (enc,) = dr.encode([job])
    cap = job.plane.cap
    assert cap == dr.stream_cap(n, lanes, 2) < int(enc["n_renorm"][0])
    with pytest.raises(OverflowError, match="stream cap"):
        _frames({k: v.numpy() for k, v in enc.items()})


def test_escape_value_beyond_i16_overflows():
    states = np.full(4, 1 << 16, np.uint32)
    stream = np.zeros(16, np.uint16)
    with pytest.raises(OverflowError, match="i16"):
        dr.frame_plane(states, stream, 0, np.array([0], np.int32),
                       np.array([40000], np.int32), 1)


def test_frame_unframe_and_is_device_frame():
    rng = np.random.default_rng(2)
    states = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    stream = rng.integers(0, 1 << 16, 50).astype(np.uint16)
    pos = np.array([3, 9, 4000], np.int32)
    val = np.array([-32768, 32767, 17], np.int32)
    f = dr.frame_plane(states, stream, 40, pos, val, 3)
    assert f == tr.frame_plane(states, stream, 40, pos, val, 3)
    assert dr.is_device_frame(f) and not dr.is_device_frame(b"\x01abc")
    lanes, st2, s2, p2, v2 = dr.unframe_plane(f, 5000)
    assert lanes == 64
    np.testing.assert_array_equal(st2, states)
    np.testing.assert_array_equal(s2, stream[:40])
    np.testing.assert_array_equal(p2[:3], pos)
    np.testing.assert_array_equal(v2[:3], val)
    assert (p2[3:] == 5056).all() and (v2[3:] == 0).all()


def test_packed_wire_roundtrips(tables):
    """pack_encs -> unpack_encs_host, and pack_frames_host ->
    upload_frames, return every plane's arrays; the extra bytes come back
    from the pull and go up through upload_bytes (both counted)."""
    rng = np.random.default_rng(5)
    jobs = []
    for kind, lanes in (("eb", 32), ("gauss", 64)):
        sym, idx = _symbols(kind, 2, 2000, tables[kind], rng)
        plane = dr.gauss_plane if kind == "gauss" else dr.eb_plane
        jobs.append(plane(torch.from_numpy(sym), torch.from_numpy(idx),
                          tables[kind][1], lanes))
    encs = dr.encode(jobs)
    extra = torch.from_numpy(rng.integers(-100, 100, (2, 36)).astype(np.int8))
    metas = [(e["states"].shape[1], e["stream"].shape[1]) for e in encs]
    got, extra_np = tcodec.unpack_encs_host(
        tcodec.pack_encs(encs, extra).numpy(), metas)
    for e, g in zip(encs, got):
        for k in e:
            np.testing.assert_array_equal(g[k], e[k].numpy().view(g[k].dtype), k)
    np.testing.assert_array_equal(extra_np.view(np.int8), extra.numpy())

    frames = [_frames(g) for g in got]
    unframed = [tcodec.DevicePlaneCoder.unframe_batch(f, 2000) for f in frames]
    cpu = torch.device("cpu")
    h2d = tcodec.WIRE_STATS["h2d_bytes"]
    planes = tcodec.upload_frames(unframed, cpu)
    for (lanes, states, stream, ep, ev), u in zip(planes, unframed):
        assert lanes == u[0] and stream.shape[1] % 4096 == 0
        for t, a in ((states, u[1]), (stream, u[2]), (ep, u[3]), (ev, u[4])):
            np.testing.assert_array_equal(t.numpy(), a.view(t.numpy().dtype))
    framed = sum(u[2].nbytes + u[0] * 4 * 2 + 8 * dr.ESC_MAX * 2 for u in unframed)  # B = 2
    assert tcodec.WIRE_STATS["h2d_bytes"] - h2d == framed
    d_extra = tcodec.upload_bytes(extra_np, cpu)
    np.testing.assert_array_equal(d_extra.numpy().view(np.int8), extra.numpy())
    assert tcodec.WIRE_STATS["h2d_bytes"] - h2d == framed + extra_np.nbytes
    assert tcodec.DevicePlaneCoder.unframe_batch([frames[0][0], b"\x01"], 2000) is None


# -- tpu_rans's entry points under their own names --------------------------


def _enc_t(enc):
    return {k: v.numpy() for k, v in enc.items()}


def _decode_batch_both(kind, frames, idx, tabs, n):
    """(port, JAX) ``*_decode_batch`` of per-image frames."""
    lanes, states, stream, ep, ev = tcodec.DevicePlaneCoder.unframe_batch(frames, n)
    port = dr.gauss_decode_batch if kind == "gauss" else dr.rans_decode_batch
    jfn = tr.gauss_decode_batch if kind == "gauss" else tr.rans_decode_batch
    got = port(torch.from_numpy(stream.view(np.int16)), torch.from_numpy(states.view(np.int32)),
               torch.from_numpy(idx), torch.from_numpy(ep), torch.from_numpy(ev),
               tabs[1], lanes, n)
    want = jax.jit(jfn, static_argnums=(6, 7))(
        jnp.asarray(stream), jnp.asarray(states), jnp.asarray(idx), jnp.asarray(ep),
        jnp.asarray(ev), tabs[0], lanes, n)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kind,lanes,B,n", CASES)
def test_batch_api_frames_identical_to_jax(tables, kind, lanes, B, n):
    """``gauss_encode_batch``/``rans_encode_batch`` give JAX's output keys
    and frames byte-identical to JAX's functions of the same name;
    ``gauss_decode_batch``/``rans_decode_batch`` of both packages decode
    them to the coded symbols."""
    tabs = tables[kind]
    rng = np.random.default_rng(lanes * 7 + n)
    sym, idx = _symbols(kind, B, n, tabs, rng)
    port = dr.gauss_encode_batch if kind == "gauss" else dr.rans_encode_batch
    jfn = tr.gauss_encode_batch if kind == "gauss" else tr.rans_encode_batch
    enc = port(torch.from_numpy(sym), torch.from_numpy(idx), tabs[1], lanes)
    want = jax.jit(jfn, static_argnums=(3,))(jnp.asarray(sym), jnp.asarray(idx), tabs[0], lanes)
    assert set(enc) == set(want)
    frames = _frames(_enc_t(enc))
    assert frames == _frames(jax.tree.map(np.asarray, want))
    got, jgot = _decode_batch_both(kind, frames, idx, tabs, n)
    np.testing.assert_array_equal(got, sym)
    np.testing.assert_array_equal(jgot, sym)


@pytest.mark.parametrize("kind,lanes,n", [("gauss", 64, 5000), ("eb", 32, 3000)])
def test_single_plane_api_equals_jax(tables, kind, lanes, n):
    """``gauss_encode``/``rans_encode`` of one flat plane: JAX's output
    shapes without the batch axis and JAX's frame; ``rans_decode`` and
    ``gauss_decode_batch`` on a batch of one decode it."""
    tabs = tables[kind]
    sym, idx = _symbols(kind, 1, n, tabs, np.random.default_rng(n))
    port = dr.gauss_encode if kind == "gauss" else dr.rans_encode
    jfn = tr.gauss_encode if kind == "gauss" else tr.rans_encode
    enc = _enc_t(port(torch.from_numpy(sym[0]), torch.from_numpy(idx[0]), tabs[1], lanes))
    want = jax.tree.map(np.asarray, jax.jit(jfn, static_argnums=(3,))(
        jnp.asarray(sym[0]), jnp.asarray(idx[0]), tabs[0], lanes))
    assert {k: v.shape for k, v in enc.items()} == {k: v.shape for k, v in want.items()}
    frame = _frames({k: v[None] for k, v in enc.items()})[0]
    assert frame == _frames({k: v[None] for k, v in want.items()})[0]
    lanes_f, states, stream, ep, ev = dr.unframe_plane(frame, n)
    args = (torch.from_numpy(stream.view(np.int16)), torch.from_numpy(states.view(np.int32)),
            torch.from_numpy(idx[0]), torch.from_numpy(ep), torch.from_numpy(ev))
    if kind == "eb":
        got = dr.rans_decode(*args, tabs[1], lanes_f, n)
    else:
        got = dr.gauss_decode_batch(*(a[None] for a in args), tabs[1], lanes_f, n)[0]
    np.testing.assert_array_equal(got.numpy(), sym[0])


def test_fused_encode_planes_is_one_launch_and_equals_jax(tables, monkeypatch):
    """JAX's plane tuples, ragged and of both kinds, through ONE call of
    the K3 wrapper; each plane's frames equal JAX's ``fused_encode_planes``."""
    rng = np.random.default_rng(12)
    specs = [("eb", 32, 2, 700), ("gauss", 64, 2, 3000), ("gauss", 128, 2, 9001)]
    data = [(kind, lanes, *_symbols(kind, B, n, tables[kind], rng))
            for kind, lanes, B, n in specs]
    calls = []
    encode_planes = dr.krans.encode_planes
    monkeypatch.setattr(dr.krans, "encode_planes",
                        lambda planes: calls.append(len(planes)) or encode_planes(planes))
    got = dr.fused_encode_planes([(kind, torch.from_numpy(s), torch.from_numpy(i),
                                   tables[kind][1], lanes) for kind, lanes, s, i in data])
    assert calls == [3]
    want = tr.fused_encode_planes([(kind, jnp.asarray(s), jnp.asarray(i), tables[kind][0],
                                    lanes) for kind, lanes, s, i in data])
    for g, w in zip(got, want):
        assert _frames(_enc_t(g)) == _frames(jax.tree.map(np.asarray, w))


@pytest.mark.parametrize("n,n_esc", [(5000, 0), (5000, 7), (70000, 200), (9001, 300)])
def test_escape_compact_equals_jax(n, n_esc):
    """Positions, values and count equal JAX's two-level compaction, also
    past the side list's capacity."""
    rng = np.random.default_rng(n + n_esc)
    sym = rng.integers(-30000, 30000, n).astype(np.int32)
    esc = np.zeros(n, bool)
    esc[rng.choice(n, n_esc, replace=False)] = True
    fill = n + 17
    got = dr.escape_compact(torch.from_numpy(sym), torch.from_numpy(esc), fill)
    want = jax.jit(tr.escape_compact, static_argnums=(2,))(jnp.asarray(sym), jnp.asarray(esc),
                                                            fill)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
