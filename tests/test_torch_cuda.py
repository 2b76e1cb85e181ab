"""Card-only tests of the port: the CUDA kernels K1-K5 against their plain
versions, the HyRES roundtrips (host and device coder) on the card
against the CPU, a device-coder decompress entering its JFIF parse with
K5 and both K4s launched, and the training step on the card against the CPU step
(loss rel 1e-4, gradient leaves 1e-3 of max |g|), K1/K2 at the training
batch, the process-wide flags after a step, and a recipe-shaped train
step and a refinement step (each also on a poisoned batch) under
sync-debug "error", and its optimizer tail on flat buffers (at most 64
launches, first-step moments against the CPU); a reference ``.pth``
imported into the device-coder codec (bytes equal to ``from_flax``'s)
and a DP step on a single-rank NCCL group against the plain step; the
refinement step (frozen leaves bit for bit, K1/K2 once a step),
``JpegCodec``'s bytes
against ``HyresCodec``'s, and ``VGGLoss``/``LPIPS`` on the card against
the CPU (rel 1e-4, the gradient into x 1e-3 of its max |g|); the ELIC and
Cheng2020 families at their published widths on seeded weights: K3 over
every plane of a request (ELIC's 11, of 32, 64 and 128 lanes) in one
launch, K4 and K5 at each lane tier, exact against the plain versions,
and the device-coder roundtrip on the card against the CPU; ``tpu_rans``'s
entry points under their names (``*_encode_batch``, ``fused_encode_planes``
as one K3 launch without a sync, ``*_decode_batch``, the single-plane
calls) against the same calls on CPU tensors; the Gaussian-mixture planes'
K6 and mixture decode bit for bit against their plain versions (rows with
NaN, infinite and extreme parameters among them; escapes), and the
mixture codec's roundtrip on the card.

Every test carries the ``cuda`` marker and skips inside its body where
there is no card. This file imports neither JAX nor ``hyres_tpu`` so that
it runs on the card's machine, which has neither, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: K1 at most 0.1% of coefficients off by one, none by more (.5 ties
move with summation order); K2 atol 1e-2 on [0, 255]; K3-K5 exact (the
coder is integer arithmetic): equal streams, states, word counts and
symbols; the roundtrip's symbols exact on the card, and its bpp within
0.5% and PSNR within 0.02 dB of the CPU run (cuDNN and CPU convolutions
sum differently).
"""

from pathlib import Path

import copy

import numpy as np
import pytest
import torch

from hyres_tpu_torch.coding import device_rans as dr
from hyres_tpu_torch.entropy import CdfTables, get_scale_table
from hyres_tpu_torch.jpeg import tables
from hyres_tpu_torch.kernels import dct
from hyres_tpu_torch.kernels import rans as krans
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.utils.flax_msgpack import load_artifact

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"

pytestmark = pytest.mark.cuda


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("n", [1, 31, 33, 700, 1536, 6144])
@pytest.mark.parametrize("quality", [1, 50])
def test_kernels_match_plain(n, quality):
    _require_cuda()
    rng = np.random.default_rng(n + quality)
    q = torch.from_numpy(tables.quality_to_qtables(quality)[0])  # a host table
    blocks = torch.from_numpy((rng.random((n, 64)) * 255).astype(np.float32)).cuda()
    before = dict(dct.LAUNCHES)
    got = dct.fdct_quant_blocks(blocks, q).cpu().numpy()
    want = dct.fdct_quant_blocks_ref(blocks, q).cpu().numpy()
    assert got.dtype == np.int32
    assert np.sum(got != want) <= 0.001 * got.size
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    coef = torch.from_numpy(rng.integers(-40, 40, (n, 64)).astype(np.int32)).cuda()
    pix = dct.dequant_idct_blocks(coef, q)
    torch.cuda.synchronize()
    np.testing.assert_allclose(pix.cpu().numpy(),
                               dct.dequant_idct_blocks_ref(coef, q).cpu().numpy(),
                               atol=1e-2)
    assert dct.LAUNCHES["fdct_quant_blocks"] == before["fdct_quant_blocks"] + 1
    assert dct.LAUNCHES["dequant_idct_blocks"] == before["dequant_idct_blocks"] + 1


def test_kernels_reject_what_they_cannot_take():
    _require_cuda()
    q = torch.ones(64)
    with pytest.raises(ValueError, match="float32"):
        dct.fdct_quant_blocks(torch.zeros((4, 64), dtype=torch.float64, device="cuda"), q)
    with pytest.raises(ValueError, match="contiguous"):
        dct.fdct_quant_blocks(torch.zeros((64, 4), device="cuda").t(), q)
    with pytest.raises(ValueError, match="int32"):
        dct.dequant_idct_blocks(torch.zeros((4, 64), device="cuda"), q)
    assert dct.fdct_quant_blocks(torch.zeros((0, 64), device="cuda"), q).shape == (0, 64)
    # the plane calls: misaligned, unblockable, mixed-dtype and CPU planes
    plane = torch.zeros((1, 16, 16), device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        dct.fdct_quant_planes([torch.zeros(260, device="cuda")[1:257].view(1, 16, 16)], [q])
    with pytest.raises(ValueError, match="multiples of 8"):
        dct.fdct_quant_planes([torch.zeros((1, 12, 16), device="cuda")], [q])
    coefs = [torch.zeros((1, 1, 1, 8, 8), dtype=dt, device="cuda")
             for dt in (torch.int8, torch.int16)]
    with pytest.raises(ValueError, match="dtype"):
        dct.dequant_idct_planes(coefs, [q, q])
    with pytest.raises(ValueError, match="CUDA"):
        dct.fdct_quant_planes([plane, plane.cpu()], [q, q])
    with pytest.raises(ValueError, match="at most 3"):
        dct.fdct_quant_planes([plane] * 4, [q] * 4)


# -- the fused plane calls ----------------------------------------------------

PLANE_SETS = {
    "main path": [(1, 768, 512), (1, 384, 256), (1, 384, 256)],
    "ragged B=2": [(2, 40, 56), (2, 24, 16), (2, 8, 72)],
    "one block": [(1, 8, 8)],
}


def _planes(shapes, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.round(rng.random(s) * 255).astype(np.float32)).cuda()
            for s in shapes]


@pytest.mark.parametrize("name", list(PLANE_SETS))
@pytest.mark.parametrize("quality", [1, 50])
def test_fused_kernels_match_plain(name, quality):
    """Fused K1 against its plain version on every plane (K1 bar), K2 on
    int8, int16 and int32 coefficients (atol 1e-2), one launch a call."""
    _require_cuda()
    shapes = PLANE_SETS[name]
    qy, qc = tables.quality_to_qtables(quality)
    qts = [qy, qc, qc][:len(shapes)]
    planes = _planes(shapes, quality)
    before = dict(dct.LAUNCHES)
    got = dct.fdct_quant_planes(planes, qts)
    assert dct.LAUNCHES["fdct_quant_blocks"] == before["fdct_quant_blocks"] + 1
    want = dct.fdct_quant_planes_ref(planes, qts)
    g = torch.cat([a.reshape(-1) for a in got]).cpu().numpy()
    w = torch.cat([a.reshape(-1) for a in want]).cpu().numpy()
    assert np.sum(g != w) <= 0.001 * g.size
    assert np.abs(g.astype(np.int64) - w).max() <= 1
    rng = np.random.default_rng(quality)
    for dt, lim in ((torch.int8, 100), (torch.int16, 1000), (torch.int32, 1023)):
        coefs = [torch.from_numpy(rng.integers(-lim, lim, c.shape)).to(dt).cuda() for c in got]
        n0 = dct.LAUNCHES["dequant_idct_blocks"]
        pix = dct.dequant_idct_planes(coefs, qts)
        assert dct.LAUNCHES["dequant_idct_blocks"] == n0 + 1
        torch.cuda.synchronize()
        for a, b in zip(pix, dct.dequant_idct_planes_ref(coefs, qts)):
            assert a.shape == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-2)


@pytest.mark.parametrize("name", list(PLANE_SETS))
def test_fused_kernels_equal_per_plane_calls(name):
    """One launch for all planes gives, bit for bit, what one launch a
    plane gives; K2 also on a batch-strided int8 view (the decompress
    path's split of one (B, n) byte plane)."""
    _require_cuda()
    shapes = PLANE_SETS[name]
    qy, qc = tables.quality_to_qtables(50)
    qts = [qy, qc, qc][:len(shapes)]
    planes = _planes(shapes, 3)
    got = dct.fdct_quant_planes(planes, qts)
    for p, q, g in zip(planes, qts, got):
        assert torch.equal(g, dct.fdct_quant_planes([p], [q])[0])
    for dt in (torch.int8, torch.int16, torch.int32):
        coefs = [c.to(dt) for c in got]
        for c, q, x in zip(coefs, qts, dct.dequant_idct_planes(coefs, qts)):
            assert torch.equal(x, dct.dequant_idct_planes([c], [q])[0])
    B = shapes[0][0]  # every plane of a set has the same B
    flat = torch.cat([c.to(torch.int8).reshape(B, -1) for c in got], 1)
    views = [v.reshape(c.shape) for v, c in
             zip(torch.split(flat, [c[0].numel() for c in got], 1), got)]
    for x, c, q in zip(dct.dequant_idct_planes(views, qts), views, qts):
        assert torch.equal(x, dct.dequant_idct_planes([c.contiguous()], [q])[0])


def test_fused_kernels_take_zero_block_planes():
    """Empty planes in any slot take no block; a call whose planes are all
    empty launches nothing."""
    _require_cuda()
    q = tables.quality_to_qtables(50)[0]
    full = _planes([(2, 16, 24), (1, 8, 8)], 5)
    for planes in ([full[0], torch.zeros((0, 16, 16), device="cuda"), full[1]],
                   [torch.zeros((1, 0, 8), device="cuda"), full[0]],
                   [full[0], full[1], torch.zeros((1, 8, 0), device="cuda")]):
        got = dct.fdct_quant_planes(planes, [q] * len(planes))
        for p, g in zip(planes, got):
            assert g.shape == (p.shape[0], p.shape[1] // 8, p.shape[2] // 8, 8, 8)
            if p.numel():
                assert torch.equal(g, dct.fdct_quant_planes([p], [q])[0])
        pix = dct.dequant_idct_planes(got, [q] * len(got))
        for g, x in zip(got, pix):
            assert x.shape == (g.shape[0], 8 * g.shape[1], 8 * g.shape[2])
            if g.numel():
                assert torch.equal(x, dct.dequant_idct_planes([g], [q])[0])
    before = dict(dct.LAUNCHES)
    empty = [torch.zeros((0, 8, 8), device="cuda")] * 2
    assert [g.shape for g in dct.fdct_quant_planes(empty, [q, q])] == [(0, 1, 1, 8, 8)] * 2
    assert dct.LAUNCHES == before


def test_fused_kernels_reject_cuda_quant_tables():
    """A quant table on the card would be read with a synchronising copy:
    the calls refuse it."""
    _require_cuda()
    q = torch.from_numpy(tables.quality_to_qtables(50)[0]).cuda()
    plane = torch.zeros((1, 8, 8), device="cuda")
    with pytest.raises(ValueError, match="host"):
        dct.fdct_quant_planes([plane], [q])
    with pytest.raises(ValueError, match="host"):
        dct.dequant_idct_planes([torch.zeros((1, 1, 1, 8, 8), dtype=torch.int8,
                                             device="cuda")], [q])
    with pytest.raises(ValueError, match="host"):
        dct.fdct_quant_blocks(plane.reshape(1, 64), q)


def test_jpeg_path_never_synchronises():
    """encode_to_coefficients and decode_with_qtables of a 768x512 image
    under sync-debug "error": no quant-table upload, no hidden sync."""
    _require_cuda()
    from hyres_tpu_torch.jpeg import core
    from hyres_tpu_torch.utils.png import load_image

    x = torch.from_numpy(load_image(IMAGE)).cuda()
    qy, qc = tables.quality_to_qtables(1)
    coef = core.encode_to_coefficients(x, 1)  # the K1/K2 matrices' one upload
    core.decode_with_qtables(coef.y, coef.cb, coef.cr, qy, qc, x.shape[1], x.shape[2])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coef = core.encode_to_coefficients(x, 1)
        c8 = [c.to(torch.int8) for c in (coef.y, coef.cb, coef.cr)]
        out = core.decode_with_qtables(*c8, qy, qc, x.shape[1], x.shape[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == x.shape
    assert torch.isfinite(out).all()


@pytest.fixture(scope="module")
def coder_tables():
    b = load_artifact(ARTIFACT)[2]["bottleneck"]
    eb = dr.build_device_tables(CdfTables(**{k: np.asarray(b[k]) for k in (
        "quantized_cdf", "cdf_length", "offset")}))
    return {"gauss": dr.build_gauss_tables(get_scale_table()), "eb": eb}


def _job(kind, lanes, B, n, tabs, seed, wide=False):
    """A seeded plane on the card with a few escapes. wide: every gaussian
    symbol at the widest scale row (enough to overflow a large plane's
    stream cap), every factorized one in one of its row's four rarest bins
    (a renorm word a symbol). Returns (encode job, (B, n) symbols, (B, n)
    rows), the last two on the CPU."""
    rng = np.random.default_rng(seed)
    t = tabs[kind]
    if kind == "gauss":
        st = get_scale_table()
        idx = (np.full((B, n), 63) if wide else rng.integers(0, 64, (B, n))).astype(np.int32)
        sym = np.round(rng.normal(0, st[idx])).astype(np.int32)
        sym[:, :3] = [20000, -25000, 31000]
        plane = dr.gauss_plane
    else:
        idx = np.broadcast_to(np.arange(n) % t.offset.shape[0], (B, n)).astype(np.int32)
        off = t.offset.numpy()[idx]
        maxv, freq = t.maxv.numpy(), t.freq.numpy()
        if wide:
            rare = np.stack([np.argsort(freq[r, :maxv[r]], kind="stable")[:4]
                             for r in range(len(maxv))])
            sym = (off + rare[idx, rng.integers(0, 4, (B, n))]).astype(np.int32)
        else:
            sym = (off + rng.integers(0, maxv[idx])).astype(np.int32)
        sym[:, 5:8] = [-31000, 31000, off[0, 7] - 5]
        plane = dr.eb_plane
    sym, idx = (torch.from_numpy(np.ascontiguousarray(a)) for a in (sym, idx))
    return plane(sym.cuda(), idx.cuda(), t.to("cuda"), lanes), sym, idx


def _cpu_job(job):
    p = job.plane
    return job._replace(plane=p._replace(**{f: getattr(p, f).cpu() for f in
                                            ("start", "freq", "low", "ks")}),
                        esc=job.esc.cpu(), sym=job.sym.cpu())


@pytest.mark.parametrize("lanes,B,n", [(32, 3, 1001), (64, 1, 5000),
                                       (128, 2, 20000), (256, 1, 33333)])
def test_rans_kernels_match_plain(coder_tables, lanes, B, n):
    """K3 (one launch for a gaussian and a factorized plane of the same
    lanes, ragged T), then K4 and K5 on its frames: exact against the
    plain versions and against the coded symbols."""
    _require_cuda()
    planes = [("gauss", dr.gauss_decode, *_job("gauss", lanes, B, n, coder_tables, n)),
              ("eb", dr.eb_decode, *_job("eb", lanes, B, n // 2 + 7, coder_tables, n + 1))]
    before = dict(krans.LAUNCHES)
    encs = dr.encode([p[2] for p in planes])
    torch.cuda.synchronize()
    want = dr.encode([_cpu_job(p[2]) for p in planes])
    assert krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 1
    for got, ref in zip(encs, want):
        for k in ref:
            assert torch.equal(got[k].cpu(), ref[k]), k
    for (kind, decode, _, sym, idx), enc in zip(planes, encs):
        frames = tcodec.DevicePlaneCoder.frames_from_enc(
            {k: v.cpu().numpy() for k, v in enc.items()})
        _, states, stream, ep, ev = tcodec.DevicePlaneCoder.unframe_batch(
            frames, sym.shape[1])
        args = [torch.from_numpy(a.view(dt)) for a, dt in
                ((stream, np.int16), (states, np.int32))]
        args += [idx] + [torch.from_numpy(a) for a in (ep, ev)]
        t = coder_tables[kind]
        got = decode(*[a.cuda() for a in args], t.to("cuda"), lanes, sym.shape[1])
        ref = decode(*args, t, lanes, sym.shape[1])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref), kind
        assert torch.equal(ref, sym), kind
    assert krans.LAUNCHES["gauss_decode"] == before["gauss_decode"] + 1
    assert krans.LAUNCHES["eb_decode"] == before["eb_decode"] + 1


def test_rans_encode_overflow_writes_in_bounds(coder_tables):
    """A plane over its stream cap keeps its last cap words, exactly as
    the plain version, and writes nothing outside its buffer: the plane
    after it in the same launch is intact."""
    _require_cuda()
    big = _job("gauss", 64, 1, 70000, coder_tables, 3, wide=True)[0]
    small = _job("gauss", 64, 2, 3000, coder_tables, 4)[0]
    encs = dr.encode([big, small])
    want = dr.encode([_cpu_job(big), _cpu_job(small)])
    assert int(want[0]["n_renorm"][0]) > big.plane.cap
    for got, ref in zip(encs, want):
        for k in ref:
            assert torch.equal(got[k].cpu(), ref[k]), k


def test_rans_kernels_reject_what_they_cannot_take(coder_tables):
    _require_cuda()
    job = _job("gauss", 64, 1, 1000, coder_tables, 1)[0]
    p = job.plane
    with pytest.raises(ValueError, match="int32"):
        krans.encode_planes([p._replace(start=p.start.to(torch.int64))])
    with pytest.raises(ValueError, match="lanes"):
        krans.encode_planes([p._replace(**{f: getattr(p, f)[:, :, :48].contiguous()
                                           for f in ("start", "freq", "low", "ks")})])
    with pytest.raises(ValueError, match="contiguous"):
        krans.encode_planes([p._replace(start=p.start.transpose(1, 2))])


def _bpp_psnr(comp, x_hat, x):
    n = (sum(len(b) for b in comp["jpeg_buffers"])
         + sum(len(s) for part in comp["strings"][0] for s in part)
         + sum(len(s) for s in comp["strings"][1]))
    mse = np.mean((x_hat.astype(np.float64) - x) ** 2)
    return n * 8 / (x.shape[1] * x.shape[2]), 10 * np.log10(1 / mse)


@pytest.mark.parametrize("coder", ["host", "device"])
def test_hyres_roundtrip_on_card_matches_cpu(coder):
    _require_cuda()
    from hyres_tpu_torch.models.hyres import HyresCodec
    from hyres_tpu_torch.utils.png import load_image

    x = np.array(load_image(IMAGE)[:, 256:384, 128:256])
    out = {}
    for device in ("cpu", "cuda"):
        codec = HyresCodec.from_artifact(ARTIFACT, device=device, coder=coder)
        comp = codec.compress(torch.from_numpy(x))
        dec = codec.decompress(comp)
        for got, coded in zip(dec["symbols"], comp["symbols"]):
            np.testing.assert_array_equal(np.asarray(torch.as_tensor(got).cpu()),
                                          np.asarray(torch.as_tensor(coded).cpu()))
        out[device] = _bpp_psnr(comp, dec["x_hat"].cpu().numpy(), x)
    (bpp_c, psnr_c), (bpp_g, psnr_g) = out["cpu"], out["cuda"]
    assert abs(bpp_g - bpp_c) <= 0.005 * bpp_c
    assert abs(psnr_g - psnr_c) <= 0.02


# -- the warp-synchronous K3-K5: ring refills, short streams, layouts,
# sub-lane counts that are not powers of two, fused ragged planes ----------

RING_WORDS = 8 * 2048  # K4/K5's stream ring in csrc/rans.cu (kChunks x kChunkWords)
DECODE = {"gauss": dr.gauss_decode, "eb": dr.eb_decode}


def _decode_both(kind, enc, idx, tabs, lanes, n, stream=None):
    """K4 or K5 on the card and its plain version on the CPU, from one
    encode's outputs (``stream`` replaces its stream); returns both (B, n)."""
    stream = enc["stream"] if stream is None else stream
    args = (stream, enc["states"], idx.cuda(), enc["esc_pos"], enc["esc_val"])
    got = DECODE[kind](*args, tabs[kind].to("cuda"), lanes, n)
    torch.cuda.synchronize()
    want = DECODE[kind](*[a.cpu() for a in args], tabs[kind], lanes, n)
    return got.cpu(), want


@pytest.mark.parametrize("kind,B", [("gauss", 1), ("gauss", 2), ("eb", 1), ("eb", 2)])
def test_gauss_decode_refills_its_stream_window(coder_tables, kind, B):
    """A plane whose stream is more than twice the decoders' shared-memory
    ring, so the ring refills several times (about ten for the gaussian
    plane, 128 lanes; the factorized plane is a word a symbol at the main
    path's 64 lanes): exact against the plain version and the coded
    symbols."""
    _require_cuda()
    n, lanes = (65000, 128) if kind == "gauss" else (40000, 64)
    job, sym, idx = _job(kind, lanes, B, n, coder_tables, 11, wide=True)
    enc = dr.encode([job])[0]
    assert int(enc["n_renorm"].min()) > 2 * RING_WORDS
    assert int(enc["n_renorm"].max()) <= job.plane.cap
    name = "gauss_decode" if kind == "gauss" else "eb_decode"
    before = krans.LAUNCHES[name]
    got, want = _decode_both(kind, enc, idx, coder_tables, lanes, n)
    assert krans.LAUNCHES[name] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(want, sym)


@pytest.mark.parametrize("kind", ["gauss", "eb"])
@pytest.mark.parametrize("B,cut", [(1, 0.5), (2, 0.3)])
def test_gauss_decode_reads_zeros_past_a_short_stream(coder_tables, kind, B, cut):
    """A stream cut short (an odd length, so with B=2 the second image's
    stream is not 16-byte aligned): reads past its end give 0, as in the
    plain version, and the symbols past the cut come out wrong the same
    way on both."""
    _require_cuda()
    n, lanes = (20000, 128) if kind == "gauss" else (20000, 64)
    job, sym, idx = _job(kind, lanes, B, n, coder_tables, 12)
    enc = dr.encode([job])[0]
    S = int(int(enc["n_renorm"].min()) * cut) | 1
    got, want = _decode_both(kind, enc, idx, coder_tables, lanes, n,
                             enc["stream"][:, :S].contiguous())
    assert torch.equal(got, want)
    assert not torch.equal(want, sym)


def _random_eb_tables(rows, max_len, seed):
    """Factorized tables of ``rows`` random CDFs of 3 to ``max_len`` entries
    (so ``max_len + 1`` bounds a row), every bin at least one slot wide."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, max_len + 1, rows)
    lengths[0] = max_len
    cdf = np.zeros((rows, max_len), np.int64)
    for r, m in enumerate(lengths):
        w = rng.random(m - 1) ** 3 + 1e-3
        f = 1 + np.floor(w / w.sum() * (65536 - (m - 1))).astype(np.int64)
        f[np.argmax(f)] += 65536 - f.sum()
        cdf[r, :m] = np.concatenate([[0], np.cumsum(f)])
        cdf[r, m:] = 65536
    return dr.build_device_tables(CdfTables(
        quantized_cdf=cdf.astype(np.int32), cdf_length=lengths.astype(np.int32),
        offset=rng.integers(-300, 0, rows).astype(np.int32)))


@pytest.mark.parametrize("rows,max_len", [(16, 300), (1300, 40), (128, 40)])
def test_eb_decode_takes_any_table(rows, max_len):
    """K5 picks its layout from (rows, cols): a rank LUT in shared memory
    for the main path's shape (128 rows of 41 bounds), the search over the
    whole row for 301 bounds (ranks past a byte) and for 1,300 rows (too
    many for the LUT's layout, though the bounds alone, 213 KB, fit a
    block's shared memory): exact against the plain version and the coded
    symbols, at 64 and 256 lanes."""
    _require_cuda()
    t = _random_eb_tables(rows, max_len, rows)
    n = 6000
    smem = krans._lib().hyk_rans_decode_smem(0, rows, max_len + 1, 64)
    assert smem <= 227 * 1024
    for lanes in (64, 256):
        job, sym, idx = _job("eb", lanes, 2, n, {"eb": t}, rows + lanes)
        enc = dr.encode([job])[0]
        got, want = _decode_both("eb", enc, idx, {"eb": t}, lanes, n)
        assert torch.equal(got, want)
        assert torch.equal(want, sym)


@pytest.mark.parametrize("kind", ["gauss", "eb"])
def test_decoders_clamp_corrupt_rows(coder_tables, kind):
    """Row indices below 0 and past the table clamp into it, on the card as
    in the plain version: the same (wrong) symbols on both."""
    _require_cuda()
    n, lanes = 5000, 64
    job, sym, idx = _job(kind, lanes, 2, n, coder_tables, 41)
    enc = dr.encode([job])[0]
    rows = coder_tables[kind].bounds.shape[0]
    bad = idx.clone()
    bad[:, 100::7] = -5
    bad[:, 103::11] = rows + 7
    got, want = _decode_both(kind, enc, bad, coder_tables, lanes, n)
    assert torch.equal(got, want)
    assert not torch.equal(want, sym)


@pytest.mark.parametrize("lanes", [96, 160])
def test_rans_kernels_take_any_multiple_of_32_lanes(coder_tables, lanes):
    """lanes / 32 = 3 and 5 sub-lanes a thread: K3 (a gaussian and a
    factorized plane in one launch), then K4 and K5 on its outputs, exact
    against their plain versions and the coded symbols. Frames need
    power-of-two lanes, so the kernels' outputs feed the decoders as
    they are."""
    _require_cuda()
    cases = [("gauss", dr.gauss_decode, 7001), ("eb", dr.eb_decode, 3001)]
    jobs = [_job(kind, lanes, 2, n, coder_tables, lanes + i)
            for i, (kind, _, n) in enumerate(cases)]
    encs = dr.encode([j[0] for j in jobs])
    torch.cuda.synchronize()
    want = dr.encode([_cpu_job(j[0]) for j in jobs])
    for got, ref in zip(encs, want):
        for k in ref:
            assert torch.equal(got[k].cpu(), ref[k]), k
    for (kind, decode, n), (_, sym, idx), enc in zip(cases, jobs, encs):
        t = coder_tables[kind]
        args = (enc["stream"], enc["states"], idx.cuda(), enc["esc_pos"], enc["esc_val"])
        got = decode(*args, t.to("cuda"), lanes, n)
        torch.cuda.synchronize()
        ref = decode(*[a.cpu() for a in args], t, lanes, n)
        assert torch.equal(got.cpu(), ref), kind
        assert torch.equal(ref, sym), kind


def test_rans_encode_fuses_three_ragged_planes(coder_tables):
    """One K3 launch of three planes of three images each, with ragged T
    and lanes (64 and 128 gaussian, 32 factorized) and an odd cap on the
    first, so that the later buffers start off 16-byte alignment: exact
    against the plain version."""
    _require_cuda()
    jobs = [_job("gauss", 64, 3, 4001, coder_tables, 21)[0],
            _job("eb", 32, 3, 777, coder_tables, 22)[0],
            _job("gauss", 128, 3, 9999, coder_tables, 23)[0]]
    p0 = jobs[0].plane
    planes = [p0._replace(cap=p0.cap + 3)] + [j.plane for j in jobs[1:]]
    assert len({p.start.shape[1] for p in planes}) == 3
    before = krans.LAUNCHES["encode_planes"]
    got = krans.encode_planes(planes)
    torch.cuda.synchronize()
    assert krans.LAUNCHES["encode_planes"] == before + 1
    want = krans.encode_planes_ref([p._replace(**{f: getattr(p, f).cpu() for f in
                                                  ("start", "freq", "low", "ks")})
                                    for p in planes])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("lanes,B,n", [(32, 3, 1001), (128, 2, 20000)])
def test_jax_named_batch_api_matches_plain(coder_tables, lanes, B, n):
    """``tpu_rans``'s names on the card against the same calls on CPU
    tensors (the plain versions): ``gauss_encode_batch`` and
    ``rans_encode_batch`` one K3 launch each; ``fused_encode_planes`` one
    K3 launch for both planes without a host synchronisation (sync-debug
    "error"); ``gauss_decode_batch`` (K4) and ``rans_decode_batch`` (K5)
    of their frames; ``gauss_encode``/``rans_encode``/``rans_decode`` on a
    batch of one."""
    _require_cuda()
    specs = []
    for kind, m, seed in (("gauss", n, 31), ("eb", n // 2 + 7, 32)):
        _, sym, idx = _job(kind, lanes, B, m, coder_tables, seed)
        specs.append((kind, sym, idx, coder_tables[kind], lanes))
    card = [(k, s.cuda(), i.cuda(), t.to("cuda"), ln) for k, s, i, t, ln in specs]
    encode = {"gauss": dr.gauss_encode_batch, "eb": dr.rans_encode_batch}
    decode = {"gauss": dr.gauss_decode_batch, "eb": dr.rans_decode_batch}
    before = dict(krans.LAUNCHES)
    got = [encode[k](s, i, t, ln) for k, s, i, t, ln in card]
    torch.cuda.synchronize()
    assert krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = dr.fused_encode_planes(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 3
    for (kind, sym, idx, t, ln), g, f, c in zip(specs, got, fused, card):
        want = encode[kind](sym, idx, t, ln)
        for k in want:
            assert torch.equal(g[k].cpu(), want[k]) and torch.equal(f[k].cpu(), want[k]), k
        frames = tcodec.DevicePlaneCoder.frames_from_enc({k: v.numpy() for k, v in want.items()})
        lanes_f, states, stream, ep, ev = tcodec.DevicePlaneCoder.unframe_batch(
            frames, sym.shape[1])
        args = [torch.from_numpy(stream.view(np.int16)), torch.from_numpy(states.view(np.int32)),
                idx, torch.from_numpy(ep), torch.from_numpy(ev)]
        k_dec = "gauss_decode" if kind == "gauss" else "eb_decode"
        b = krans.LAUNCHES[k_dec]
        out = decode[kind](*[a.cuda() for a in args], c[3], lanes_f, sym.shape[1])
        torch.cuda.synchronize()
        assert krans.LAUNCHES[k_dec] == b + 1
        assert torch.equal(out.cpu(), decode[kind](*args, t, lanes_f, sym.shape[1]))
        assert torch.equal(out.cpu(), sym)
        single = (dr.gauss_encode if kind == "gauss" else dr.rans_encode)(
            c[1][0], c[2][0], c[3], ln)
        for k in want:
            assert torch.equal(single[k].cpu(), want[k][0]), k
        if kind == "eb":
            one = dr.rans_decode(*[a[0].cuda() for a in args], c[3], lanes_f, sym.shape[1])
            assert torch.equal(one.cpu(), sym[0])


def test_k3_division_is_exact_for_every_freq():
    """K3 divides by a float reciprocal estimate and one fixup
    (``divmod_u16`` in csrc/rans.cu): for every freq in [1, 2^16] and
    dividends at both ends of the range the encoder reaches
    (n < freq << 16) and at random in it, quotient and remainder equal
    plain division's."""
    _require_cuda()
    d = torch.arange(1, (1 << 16) + 1, dtype=torch.int64)
    top = d << 16
    rng = np.random.default_rng(7)
    rand = torch.from_numpy((rng.random((16, d.numel())) * top.numpy()).astype(np.int64))
    n = torch.cat([torch.stack([torch.zeros_like(d), torch.ones_like(d), d - 1, d,
                                top // 2, top - d - 1, top - d, top - 1]), rand])
    n = torch.minimum(n, top - 1)
    dd = d.expand_as(n)
    nc, dc = (krans._u32_bits(x.reshape(-1)).cuda() for x in (n, dd))
    q = torch.empty_like(nc)
    r = torch.empty_like(nc)
    rc = krans._lib().hyk_divmod_check(nc.data_ptr(), dc.data_ptr(), q.data_ptr(),
                                       r.data_ptr(), nc.numel(),
                                       torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    q, r = (x.cpu().long() & 0xFFFFFFFF for x in (q, r))
    n, dd = n.reshape(-1), dd.reshape(-1)
    assert torch.equal(q, n // dd)
    assert torch.equal(r, n % dd)


def test_rans_kernels_take_unaligned_inputs(coder_tables):
    """K3's inputs and K4's rows at a 4-byte offset (the kernels read them
    16 bytes at a time; the wrappers copy such tensors): exact against the
    plain versions."""
    _require_cuda()
    n = 5001
    job, sym, idx = _job("gauss", 128, 2, n, coder_tables, 31)
    p = job.plane

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    q = p._replace(**{f: shifted(getattr(p, f)) for f in ("start", "freq", "low", "ks")})
    assert q.start.data_ptr() % 16
    (got,) = krans.encode_planes([q])
    torch.cuda.synchronize()
    (want,) = krans.encode_planes_ref([p._replace(**{f: getattr(p, f).cpu() for f in
                                                     ("start", "freq", "low", "ks")})])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    enc = dr.encode([job])[0]
    T = -(-n // 128)
    rows = shifted(dr.to_tl(idx.cuda(), T, 128, 0))
    gt = coder_tables["gauss"]
    args = (rows, gt.bounds.cuda(), gt.params.cuda(), enc["stream"], enc["states"],
            enc["esc_pos"], enc["esc_val"])
    out = krans.gauss_decode(*args)
    torch.cuda.synchronize()
    ref = krans.gauss_decode_ref(*[a.cpu() for a in args])
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ref[:, :n], sym)


# -- the serving entry points: dispatch halves, the stream, the pull, .hyc ---


@pytest.fixture(scope="module")
def device_codec():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hyres_tpu_torch.models.hyres import HyresCodec

    return HyresCodec.from_artifact(ARTIFACT, device="cuda", coder="device")


def _requests(n):
    from hyres_tpu_torch.utils.png import load_image

    img = torch.from_numpy(load_image(IMAGE)).cuda()
    base = [img[:, :256, :256], img[:, 256:512, 128:384].flip(2), img[:, 512:, 256:].flip(1)]
    return [base[i % 3].contiguous() for i in range(n)]


def test_dispatch_halves_never_synchronise(device_codec):
    """_compress_dispatch, a replay of its CUDA graph, and
    _dec_dispatch_from_comp under sync-debug "error": no pageable copy, no
    scalar upload, no wait."""
    _require_cuda()
    from hyres_tpu_torch.utils.device import wait_event

    (x,) = _requests(1)
    # warm: the K1/K2 matrices' one upload, the pull's marks, the graph
    device_codec.inference(x)
    device_codec.inference(x)
    torch.cuda.synchronize()
    replays = tcodec.WIRE_STATS["graph_replays"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = device_codec._compress_dispatch(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tcodec.WIRE_STATS["graph_replays"] == replays + 1
    comp = device_codec._compress_finish(state)
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_hat, symbols, _, done = device_codec._dec_dispatch_from_comp(comp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wait_event(done)
    for got, coded in zip(symbols, comp["symbols"]):
        assert torch.equal(got, coded)
    assert x_hat.shape == x.shape and torch.isfinite(x_hat).all()


def test_jfif_parse_runs_behind_the_queued_decode_chain(device_codec, monkeypatch):
    """A HyRES device-coder decompress has launched K5 and both K4s when it
    enters the JFIF parse, counts one overlapped parse and no fallback, and
    gives a sequential inference's reconstruction and symbols."""
    _require_cuda()
    from hyres_tpu_torch.models import hyres as thyres

    (x,) = _requests(1)
    ref = device_codec.inference(x)
    parse, at_parse = thyres.ParsedJpeg, []

    def parsed(buf):
        at_parse.append(dict(krans.LAUNCHES))
        return parse(buf)

    monkeypatch.setattr(thyres, "ParsedJpeg", parsed)
    before = dict(krans.LAUNCHES)
    tcodec.reset_wire_stats()
    dec = device_codec.decompress(ref["compressed"])
    assert len(at_parse) == 1
    assert at_parse[0]["eb_decode"] == before["eb_decode"] + 1
    assert at_parse[0]["gauss_decode"] == before["gauss_decode"] + 2
    assert tcodec.WIRE_STATS["overlapped_parses"] == 1
    assert tcodec.WIRE_STATS["host_fallbacks"] == 0
    assert torch.equal(dec["x_hat"], ref["x_hat"])
    for got, want in zip(dec["symbols"], ref["symbols"]):
        assert torch.equal(got, want)


def test_stream_of_four_equals_sequential(device_codec):
    _require_cuda()
    xs = _requests(4)
    seq = [device_codec.inference(x) for x in xs]
    for depth in (2, 3):
        outs = device_codec.inference_stream(xs, depth=depth)
        for a, b in zip(seq, outs):
            assert b["strings"] == a["compressed"]["strings"]
            assert b["compressed"]["jpeg_buffers"] == a["compressed"]["jpeg_buffers"]
            assert torch.equal(b["x_hat"], a["x_hat"])


def test_pinned_pull_equals_pageable_copy():
    _require_cuda()
    blob = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (2, 123457), dtype=np.uint8)).cuda()
    before = tcodec.WIRE_STATS["d2h_syncs"]
    pending = tcodec.pull_dispatch(blob)
    assert pending[0].is_pinned() and pending[1] is not None
    got = tcodec.pull_finish(pending)
    assert tcodec.WIRE_STATS["d2h_syncs"] == before + 1
    np.testing.assert_array_equal(got, blob.cpu().numpy())


def test_hyc_roundtrip_with_device_coder(device_codec, tmp_path):
    _require_cuda()
    from hyres_tpu_torch.coding.container import (coder_for_container, pack_compressed,
                                                  unpack_compressed)

    (x,) = _requests(1)
    comp = device_codec.compress(x)
    path = tmp_path / "a.hyc"
    path.write_bytes(pack_compressed(comp, model="hyres", N=128, M=192, jpeg_quality=1,
                                     coder="device"))
    doc = unpack_compressed(path.read_bytes())
    assert doc["coder"] == "tpu" and coder_for_container(doc["coder"]) == "device"
    a = device_codec.decompress(comp)
    b = device_codec.decompress(doc["payload"])
    assert torch.equal(a["x_hat"], b["x_hat"])
    for got, coded in zip(b["symbols"], comp["symbols"]):
        assert torch.equal(got, coded)


# -- the training path: the step on the card against the CPU step, K1/K2 at
# the training batch, the process-wide flags ---------------------------------


def _training_batch(n: int, size: int) -> np.ndarray:
    from hyres_tpu_torch.utils.png import read_png

    img = read_png(IMAGE).astype(np.float32) / 255.0
    srcs = [img, img[:, ::-1], img[::-1]]
    rng = np.random.default_rng(n + size)
    out = []
    for _ in range(n):
        s = srcs[int(rng.integers(3))]
        y0, x0 = (int(rng.integers(0, d - size + 1)) for d in s.shape[:2])
        out.append(s[y0:y0 + size, x0:x0 + size])
    return np.ascontiguousarray(np.stack(out))


def test_train_step_on_card_matches_cpu():
    """The first step's loss (rel 1e-4) and every gradient leaf (1e-3 of
    its max |g|) on the card against the CPU with the plain K1/K2, at
    full width on the artifact's weights, with the same noise."""
    _require_cuda()
    from hyres_tpu_torch.losses import rate_distortion_loss
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train.engine import train_numerics
    from hyres_tpu_torch.utils.convert import load_state_dict

    _, params, _ = load_artifact(ARTIFACT)
    batch = _training_batch(2, 128)
    rng = np.random.default_rng(3)
    res = {}
    for dev in ("cuda", "cpu"):
        model = ResidualJPEGCompression(128, 192, 1)
        load_state_dict(model, params)
        model.to(dev)
        y_shape, z_shape = model.residual_model.latent_shapes(batch.shape)
        if not res:
            noise = {"z": rng.uniform(-0.5, 0.5, model.residual_model.entropy_bottleneck
                                      .noise_shape(z_shape)).astype(np.float32),
                     "y_anchor": rng.uniform(-0.5, 0.5, y_shape).astype(np.float32),
                     "y_nonanchor": rng.uniform(-0.5, 0.5, y_shape).astype(np.float32)}
        x = torch.from_numpy(batch).to(dev)
        with train_numerics(torch.device(dev)):
            out = model(x, noisequant=True,
                        noise={k: torch.from_numpy(v).to(dev) for k, v in noise.items()})
            loss = rate_distortion_loss(out, x, 0.015, 0.0)["loss"]
            loss.backward()
        res[dev] = (float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()
                                  if p.grad is not None})
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    assert gc.keys() == gp.keys()
    for n in gp:
        scale = float(gp[n].abs().max())
        assert float((gc[n] - gp[n]).abs().max()) <= 1e-3 * scale, n


def test_k1_k2_on_the_training_batch_match_plain():
    """K1 and K2 on 16 x 256 x 256 (24,576 blocks, one launch each):
    coefficients and exact scan bits equal to the plain version's, K2
    within 1e-4."""
    _require_cuda()
    from hyres_tpu_torch.jpeg import core

    x = torch.from_numpy(_training_batch(16, 256)).cuda()
    qy, qc = tables.quality_to_qtables(1)
    y, cb, cr = core.rgb_to_ycbcr(x)
    planes = [y, core.downsample_420(cb), core.downsample_420(cr)]
    before = dict(dct.LAUNCHES)
    got = dct.fdct_quant_planes(planes, [qy, qc, qc])
    dec = dct.dequant_idct_planes(got, [qy, qc, qc])
    assert dct.LAUNCHES["fdct_quant_blocks"] == before["fdct_quant_blocks"] + 1
    assert dct.LAUNCHES["dequant_idct_blocks"] == before["dequant_idct_blocks"] + 1
    want = dct.fdct_quant_planes_ref(planes, [qy, qc, qc])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(core.scan_bits(core.JpegCoefficients(*got, 256, 256)),
                       core.scan_bits(core.JpegCoefficients(*want, 256, 256)))
    for d, r in zip(dec, dct.dequant_idct_planes_ref(got, [qy, qc, qc])):
        assert float((d - r).abs().max()) <= 1e-4


def test_train_step_leaves_process_flags_as_they_were():
    """The step's cuDNN flags are scoped: the coder's numerics are back
    when it returns."""
    _require_cuda()
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # the coder's numerics, process-wide
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert flags == (True, False, False, False)
    model = ResidualJPEGCompression(16, 24, 1).cuda()
    main, aux = configure_optimizers(model)
    step = make_train_step(create_train_state(model, main, aux), 0.015)
    m = step(torch.from_numpy(_training_batch(2, 64)).cuda(),
             torch.Generator("cuda").manual_seed(0), True)
    assert float(m["skipped_nonfinite"]) == 0.0
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags



def test_train_and_refine_steps_read_nothing_on_the_host():
    """The NaN guard selects on the device, as JAX does: after a warm-up
    step, a recipe-shaped train step (the artifact's weights, 16 x
    256x256), a poisoned one (skipped) and a refinement step run under
    sync-debug "error"."""
    _require_cuda()
    from hyres_tpu_torch.cli.refine_training import freeze_codec, make_refine_step
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.train.optimizers import adam
    from hyres_tpu_torch.utils.convert import load_state_dict

    _, params, _ = load_artifact(ARTIFACT)
    x = torch.from_numpy(_training_batch(16, 256)).cuda()
    bad = torch.full_like(x, float("nan"))
    model = ResidualJPEGCompression(128, 192, 1)
    load_state_dict(model, params)
    model.cuda()
    main, aux = configure_optimizers(model)
    step = make_train_step(create_train_state(model, main, aux), 0.015)
    gen = torch.Generator("cuda").manual_seed(0)
    step(x, gen, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        good, skipped = step(x, gen, True), step(bad, gen, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(good["skipped_nonfinite"]) == 0.0 and float(skipped["skipped_nonfinite"]) == 1.0

    model = ResidualJPEGCompression(128, 192, 1)
    load_state_dict(model, params)
    model.cuda()
    opt = adam(freeze_codec(model), 1e-4)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    refine = make_refine_step(model, opt)
    refine(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        good, skipped = refine(x), refine(bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(good["skipped_nonfinite"]) == 0.0 and float(skipped["skipped_nonfinite"]) == 1.0

def test_flat_optimizer_tail_on_card():
    """The training step's optimizer tail on flat buffers. A profiled
    recipe-shaped step (the artifact's weights, 16 x 256x256, after two
    warm-up steps and one binding) launches at most 64 kernels from host
    ops inside the ``optim.*`` spans; the aux loss's own forward (wrapped
    here in a range) and backward (on autograd's device thread, outside
    the spans' host tree) are the model's work and left out. A first step
    at 2 x 128 with the same noise on the card and on the CPU: loss rel
    1e-4, each leaf's first moment and the square root of its second
    within 1e-3 of the CPU's largest."""
    _require_cuda()
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
    from hyres_tpu_torch.train.optimizers import OPTIM_STATS
    from hyres_tpu_torch.utils.convert import load_state_dict

    _, params, _ = load_artifact(ARTIFACT)

    def state(dev, noise=None):
        model = ResidualJPEGCompression(128, 192, 1)
        load_state_dict(model, params)
        model.to(dev)
        if noise is not None:
            model.draw_noise = lambda *a: {k: torch.from_numpy(v).to(dev)
                                           for k, v in noise.items()}
        return create_train_state(model, *configure_optimizers(model, 1e-4, 1e-3, 1.0))

    st = state("cuda")
    step = make_train_step(st, 0.0032)
    x = torch.from_numpy(_training_batch(16, 256)).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    binds = OPTIM_STATS["binds"]
    for _ in range(2):
        step(x, gen, True)
    torch.cuda.synchronize()
    aux_loss = st.model.aux_loss

    def ranged_aux_loss():
        with torch.profiler.record_function("test.aux_loss"):
            return aux_loss()

    st.model.aux_loss = ranged_aux_loss
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(x, gen, True)
        torch.cuda.synchronize()
    assert OPTIM_STATS["binds"] == binds + 1
    spans, launches = set(), []
    for e in prof.events():  # each kernel is linked to the host op that launched it
        p = e
        while p is not None and not p.name.startswith(("hyres.optim.", "test.aux_loss")):
            p = p.cpu_parent
        if p is not None and p.name.startswith("hyres.optim."):
            spans.add(p.name)
            if not e.name.startswith("cu"):  # the runtime's own events, not ops
                launches += [k.name for k in e.kernels]
    assert spans == {"hyres.optim." + k for k in ("guard", "clip", "adam", "aux", "select")}
    assert 0 < len(launches) <= 64, launches

    rng = np.random.default_rng(3)
    batch = _training_batch(2, 128)
    res = {}
    for dev in ("cuda", "cpu"):
        if not res:
            y_shape, z_shape = st.model.residual_model.latent_shapes(batch.shape)
            noise = {"z": rng.uniform(-0.5, 0.5, st.model.residual_model.entropy_bottleneck
                                      .noise_shape(z_shape)).astype(np.float32),
                     "y_anchor": rng.uniform(-0.5, 0.5, y_shape).astype(np.float32),
                     "y_nonanchor": rng.uniform(-0.5, 0.5, y_shape).astype(np.float32)}
        s = state(dev, noise)
        m = make_train_step(s, 0.015)(torch.from_numpy(batch).to(dev),
                                      torch.Generator(dev), True)
        moments = {}
        for n, p in s.model.named_parameters():
            opt = s.aux if n.endswith("quantiles") else s.main
            moments[n] = (opt.state[p]["exp_avg"].cpu(), opt.state[p]["exp_avg_sq"].sqrt().cpu())
        res[dev] = (float(m["loss"]), moments)
    (lc, mc), (lp, mp) = res["cuda"], res["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    assert mc.keys() == mp.keys()
    for n in mp:
        for a, b in zip(mc[n], mp[n]):
            assert float((a - b).abs().max()) <= 1e-3 * max(float(b.abs().max()), 1e-30), n

# -- the refinement phase, JpegCodec, the perceptual losses ----------------------


def test_refine_step_freezes_the_codec_and_runs_k1_k2_once():
    _require_cuda()
    from hyres_tpu_torch.cli.refine_training import freeze_codec, make_refine_step
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.utils.convert import load_state_dict

    _, params, _ = load_artifact(ARTIFACT)
    model = ResidualJPEGCompression(128, 192, 1)
    load_state_dict(model, params)
    model.cuda()
    opt = torch.optim.Adam(freeze_codec(model), lr=1e-4)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    step = make_refine_step(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.from_numpy(_training_batch(4, 128)).cuda()
    dct.reset_launches()
    for _ in range(3):
        m = step(x)
        assert float(m["skipped_nonfinite"]) == 0.0 and torch.isfinite(m["loss"])
    torch.cuda.synchronize()
    assert dict(dct.LAUNCHES) == {"fdct_quant_blocks": 3, "dequant_idct_blocks": 3}
    moved = [n for n, p in model.named_parameters() if not torch.equal(before[n], p.detach())]
    assert moved and all(n.startswith("refine.") for n in moved)


def test_jpeg_codec_bytes_equal_hyres_jpeg_buffers(device_codec):
    _require_cuda()
    from hyres_tpu_torch.jpeg import JpegCodec

    xs = _requests(2)
    x = torch.cat([xs[0], xs[1]])
    codec = JpegCodec(1)
    dct.reset_launches()
    bufs = codec.compress(x)
    assert dct.LAUNCHES["fdct_quant_blocks"] == 1
    assert bufs == device_codec.compress(x)["jpeg_buffers"]
    dct.reset_launches()
    dec = codec.decompress(bufs)
    assert dct.LAUNCHES["dequant_idct_blocks"] == 1
    assert torch.equal(dec, device_codec.decode_jpeg(bufs))


def _pair(n, size):
    x = _training_batch(n, size)
    y = np.clip(x + 0.05 * np.random.default_rng(1).standard_normal(x.shape), 0, 1)
    return x, y.astype(np.float32)


def test_vgg_and_lpips_on_card_match_cpu(tmp_path, monkeypatch):
    _require_cuda()
    from hyres_tpu_torch.losses import LPIPS, VGGLoss
    from hyres_tpu_torch.losses.lpips import AlexFeatures
    from hyres_tpu_torch.utils.device import full_float32

    rng = np.random.default_rng(9)
    shapes = {f"net.{k}": v.shape for k, v in AlexFeatures().state_dict().items()}
    shapes.update({f"lin{i}.weight": (1, c, 1, 1)
                   for i, c in enumerate((64, 192, 384, 256, 256))})
    np.savez(tmp_path / "lpips.npz", **{
        k: np.abs(rng.normal(0, np.sqrt(2.0 / np.prod(v[1:])), v)).astype(np.float32)
        if k.startswith("lin") else rng.normal(0, np.sqrt(2.0 / np.prod(v[1:])) if len(v) > 1
                                               else 0.01, v).astype(np.float32)
        for k, v in shapes.items()})
    monkeypatch.delenv("HYRES_VGG16_WEIGHTS", raising=False)
    x, y = _pair(2, 128)
    res = {}
    for dev in ("cuda", "cpu"):
        vgg = VGGLoss().to(dev)
        lp = LPIPS(str(tmp_path / "lpips.npz")).to(dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        with full_float32():
            v = vgg(xt, torch.from_numpy(y).to(dev))
            v.backward()
            d = lp(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        res[dev] = (float(v.detach()), xt.grad.cpu(), float(d))
    (vc, gc, dc), (vp, gp, dp) = res["cuda"], res["cpu"]
    assert abs(vc - vp) <= 1e-4 * abs(vp) and abs(dc - dp) <= 1e-4 * abs(dp)
    # sign(a - b) of the L1 term flips single elements where the two
    # activations nearly tie, so the gradient is held in norm
    assert float(torch.linalg.vector_norm(gc - gp)) <= 1e-2 * float(torch.linalg.vector_norm(gp))


# -- the baseline families at full width on seeded weights: K3 over ELIC's
# 11 planes, K4 at each lane tier and K5, the roundtrips on the card --------

_BASELINE_STATES: dict = {}


def _baseline_state(family: str) -> dict:
    """The family's seeded weights at its published width, as
    ``chip_smoke.py`` makes them: flax's initialisers from torch.Generator
    seed 0, the scales' output bias set to 2.0, and the factorized prior
    fit on the CPU to the model's z of a 256x256 crop (100 Adam steps on
    its noisy rate), its quantiles then refit, so that the random model's
    planes fit the device coder's escape list and stream caps."""
    if family in _BASELINE_STATES:
        return _BASELINE_STATES[family]
    from hyres_tpu_torch import models
    from hyres_tpu_torch.entropy import refit_model_quantiles
    from hyres_tpu_torch.nn import init_parameters
    from hyres_tpu_torch.utils.convert import from_flax, to_flax
    from hyres_tpu_torch.utils.png import load_image

    if family == "elic":
        model = models.LightWeightELIC()
        heads = [(getattr(model, f"param_aggregation_{i}").Conv_2.Conv_0.bias, slice(g, None))
                 for i, g in enumerate(model.groups)]
    else:
        model = models.Cheng2020withCheckerboard()
        heads = [(model.entropy_parameters.Conv_2.Conv_0.bias, slice(0, model.N))]
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for bias, scales in heads:
            bias[scales] = 2.0
        _, z = model.analysis(torch.from_numpy(load_image(IMAGE)[:, 128:384, 256:512].copy()))
    eb = model.entropy_bottleneck
    opt = torch.optim.Adam([p for n, p in eb.named_parameters() if n != "quantiles"], lr=1e-2)
    gen = torch.Generator().manual_seed(0)
    for _ in range(100):
        loss = -torch.log2(eb(z, noise=True, generator=gen)[1]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    _BASELINE_STATES[family] = from_flax(refit_model_quantiles({"params": to_flax(model)})["params"])
    return _BASELINE_STATES[family]


def _baseline_codec(family: str, device: str, coder: str = "device"):
    """The family on its seeded weights, tables baked by ``update``."""
    from hyres_tpu_torch import models

    if family == "elic":
        model, codec_cls = models.LightWeightELIC(), models.ElicCodec
    else:
        model, codec_cls = models.Cheng2020withCheckerboard(), models.Cheng2020Codec
    model.load_state_dict(_baseline_state(family))
    codec = codec_cls(model, coder=coder, device=device)
    codec.update(force=True)
    return codec


def _baseline_latents(codec, x):
    """x -> (the device coder's encode jobs of one request, per job its
    (1, n) table rows on the CPU)."""
    from hyres_tpu_torch.jpeg.core import pad_to_multiple

    with torch.inference_mode():
        z_sym, planes = codec.latents(pad_to_multiple(x, 64))
    z_job, y_jobs = codec._split_z(codec.device_jobs(z_sym, planes))
    jobs = y_jobs + [z_job]  # the y planes first, as ELIC's
    C = z_sym.shape[-1]
    rows = [i.reshape(1, -1).to(torch.int32).cpu() for _, i in planes]
    rows.append(torch.arange(z_sym[0].numel(), dtype=torch.int32)[None] % C)
    return jobs, rows


@pytest.fixture(scope="module")
def baseline_jobs():
    """Per family and image size (the 768x512 image and a 256x256 crop of
    it): the codec, its encode jobs (y planes, then z) and their rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from hyres_tpu_torch.utils.png import load_image

    img = torch.from_numpy(load_image(IMAGE)).cuda()
    out = {}
    for family in ("elic", "cheng2020"):
        codec = _baseline_codec(family, "cuda")
        for size, x in (("full", img), ("crop", img[:, 128:384, 256:512].contiguous())):
            out[family, size] = (codec, *_baseline_latents(codec, x))
    return out


# the lanes of each plane (y planes, then z): the coder's own choice
# (lanes_for), as the reference's, so the frames match
BASELINE_LANES = {
    ("elic", "full"): [64, 64, 64, 64, 128, 128, 128, 128, 128, 128, 128],
    ("elic", "crop"): [32, 32, 32, 32, 32, 32, 64, 64, 128, 128, 32],
    ("cheng2020", "full"): [128, 128, 32],
    ("cheng2020", "crop"): [32, 32, 32],
}


@pytest.mark.parametrize("key", list(BASELINE_LANES))
def test_k3_encodes_baseline_planes_in_one_launch(baseline_jobs, key):
    """Every plane of a request (ELIC: 11, of 32, 64 and 128 lanes) in one
    K3 launch, exact against the plain version on CPU copies, with no
    escape and every stream within its cap."""
    _require_cuda()
    _, jobs, _ = baseline_jobs[key]
    lanes = BASELINE_LANES[key]
    assert [j.lanes for j in jobs] == lanes
    before = krans.LAUNCH_SHAPES["encode_planes", tuple(lanes)]
    encs = dr.encode(jobs)
    torch.cuda.synchronize()
    assert krans.LAUNCH_SHAPES["encode_planes", tuple(lanes)] == before + 1
    want = dr.encode([_cpu_job(j) for j in jobs])
    for got, ref in zip(encs, want):
        for k in ref:
            assert torch.equal(got[k].cpu(), ref[k]), k
        assert int(ref["n_esc"][0]) == 0
        assert int(ref["n_renorm"][0]) <= got["stream"].shape[1]


@pytest.mark.parametrize("key,plane", [
    (("elic", "crop"), 0), (("elic", "crop"), 6), (("elic", "crop"), 9),
    (("elic", "full"), 0), (("elic", "crop"), 10), (("elic", "full"), 10),
    (("cheng2020", "full"), 0), (("cheng2020", "full"), 2)])
def test_k4_k5_decode_baseline_planes(baseline_jobs, key, plane):
    """K4 on y planes at 32, 64 and 128 lanes and K5 on z at 32 and 128
    lanes: exact against the plain versions on the CPU and the coded
    symbols."""
    _require_cuda()
    codec, jobs, rows = baseline_jobs[key]
    job, idx = jobs[plane], rows[plane]
    kind = "eb" if plane == len(jobs) - 1 else "gauss"
    tabs = codec.device_coder.eb if kind == "eb" else codec.device_coder.gauss
    (enc,) = dr.encode([job])
    n = idx.shape[1]
    name = "eb_decode" if kind == "eb" else "gauss_decode"
    before = krans.LAUNCH_SHAPES[name, job.lanes]
    got = DECODE[kind](enc["stream"], enc["states"], idx.cuda(), enc["esc_pos"],
                       enc["esc_val"], tabs, job.lanes, n)
    torch.cuda.synchronize()
    assert krans.LAUNCH_SHAPES[name, job.lanes] == before + 1
    want = DECODE[kind](*[enc[k].cpu() for k in ("stream", "states")], idx,
                        *[enc[k].cpu() for k in ("esc_pos", "esc_val")],
                        tabs.to("cpu"), job.lanes, n)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, job.sym[:, :n].cpu())


def _baseline_nbytes(strings) -> int:
    if isinstance(strings, (bytes, bytearray)):
        return len(strings)
    return sum(_baseline_nbytes(s) for s in strings)


@pytest.mark.parametrize("family", ["elic", "cheng2020"])
def test_baseline_roundtrip_on_card_matches_cpu(family):
    """A device-coder roundtrip of a 256x256 crop at full width on the card
    and on the CPU: each exact against its own symbols, at most 0.1% of the
    symbols apart (float stages in another summation order), the card's
    bpp within 0.5% and PSNR within 0.02 dB of the CPU's; no launch and no
    fallback on the CPU."""
    _require_cuda()
    from hyres_tpu_torch.utils.png import load_image

    x = np.array(load_image(IMAGE)[:, 128:384, 256:512])
    out = {}
    for device in ("cpu", "cuda"):
        codec = _baseline_codec(family, device)
        tcodec.reset_wire_stats()
        krans.reset_launches()
        comp = codec.compress(torch.from_numpy(x))
        dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
        assert tcodec.WIRE_STATS["host_fallbacks"] == 0
        if device == "cpu":
            assert not any(krans.LAUNCHES.values())
        for got, coded in zip(dec["symbols"], comp["symbols"]):
            assert torch.equal(got.cpu(), coded.cpu())
        x_hat = dec["x_hat"].cpu().numpy().astype(np.float64)
        mse = np.mean((x_hat - x) ** 2)
        out[device] = (_baseline_nbytes(comp["strings"]) * 8 / (256 * 256),
                       10 * np.log10(1 / mse), [s.cpu() for s in comp["symbols"]])
    (bpp_c, psnr_c, sym_c), (bpp_g, psnr_g, sym_g) = out["cpu"], out["cuda"]
    diff = sum(int((a != b).sum()) for a, b in zip(sym_c, sym_g))
    total = sum(a.numel() for a in sym_c)
    assert diff <= 0.001 * total, f"{diff} of {total} symbols differ"
    assert abs(bpp_g - bpp_c) <= 0.005 * bpp_c
    assert abs(psnr_g - psnr_c) <= 0.02


# -- the reference .pth import and data parallelism --------------------------------


def test_pth_import_on_card_serves_the_from_flax_bytes(tmp_path):
    """The artifact's weights as a reference ``.pth`` (CompressAI names,
    with coder buffers and a stray ``se_block.*`` key), imported: the tree
    equals the artifact's leaf for leaf, and the f32 device-coder codec of
    it serves the bytes and ``x_hat`` of the ``from_flax`` codec of the
    same weights, each with a fresh ``update()``."""
    _require_cuda()
    from hyres_tpu_torch.models.hyres import HyresCodec, ResidualJPEGCompression
    from hyres_tpu_torch.utils import torch_convert as tc
    from hyres_tpu_torch.utils.convert import load_state_dict
    from hyres_tpu_torch.utils.png import load_image

    config, params, _ = load_artifact(ARTIFACT)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in tc.export_hyres(params).items()}
    sd["se_block.fc.0.weight"] = torch.zeros(4, 64)
    sd["residual_model.entropy_bottleneck._quantized_cdf"] = torch.zeros(128, 9, dtype=torch.int32)
    sd["residual_model.gaussian_conditional.scale_table"] = torch.linspace(0.11, 256, 64)
    torch.save({"epoch": 1, "state_dict": sd, "optimizer": {}}, tmp_path / "ref.pth.tar")
    imported = tc.convert_hyres(tc.load_pth(tmp_path / "ref.pth.tar"))["params"]

    def leaves(t, p=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, p + (k,))
            else:
                yield "/".join(p + (k,)), v

    got, want = dict(leaves(imported)), dict(leaves(params))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    x = torch.from_numpy(load_image(IMAGE))[:, :256, :256].contiguous().cuda()
    outs = []
    for tree in (imported, params):
        model = ResidualJPEGCompression(config["N"], config["M"], config["jpeg_quality"])
        load_state_dict(model, tree)
        codec = HyresCodec(model, coder="device", device="cuda")
        assert codec.update()
        comp = codec.compress(x)
        outs.append((comp, codec.decompress(comp)))
    (ca, da), (cb, db) = outs
    assert ca["strings"] == cb["strings"] and ca["jpeg_buffers"] == cb["jpeg_buffers"]
    assert torch.equal(da["x_hat"], db["x_hat"])


def test_single_rank_nccl_dp_step_matches_plain(monkeypatch):
    """A DP step on a single-rank NCCL group (``HYRES_MULTIHOST=1``)
    against the plain step from the same state and generator seed: loss
    rel 1e-4, each gradient leaf 1e-3 of its max |g|, K1/K2 once."""
    _require_cuda()
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.nn import init_parameters
    from hyres_tpu_torch.parallel import (data_parallel_mesh, local_device,
                                          maybe_initialize_distributed)
    from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HYRES_MULTIHOST", "1")
    assert maybe_initialize_distributed("cuda", timeout=120)
    try:
        assert torch.distributed.get_backend() == "nccl"
        dp = data_parallel_mesh(local_device("cuda"))
        batch = torch.from_numpy(_training_batch(4, 64)).cuda()
        res = {}
        for name in ("plain", "dp"):
            model = init_parameters(ResidualJPEGCompression(16, 24, 1),
                                    torch.Generator().manual_seed(0)).cuda()
            main, aux = configure_optimizers(model)
            step = make_train_step(create_train_state(model, main, aux), 0.015,
                                   dp=dp if name == "dp" else None)
            before = dict(dct.LAUNCHES)
            m = step(batch, torch.Generator("cuda").manual_seed(1), True)
            torch.cuda.synchronize()
            assert float(m["skipped_nonfinite"]) == 0.0
            assert dct.LAUNCHES["fdct_quant_blocks"] == before["fdct_quant_blocks"] + 1
            res[name] = (float(m["loss"]), {n: p.grad.cpu() for n, p in model.named_parameters()})
        (lp, gp), (ld, gd) = res["plain"], res["dp"]
        assert abs(ld - lp) <= 1e-4 * abs(lp)
        for n in gp:
            assert float((gd[n] - gp[n]).abs().max()) <= 1e-3 * float(gp[n].abs().max()), n
    finally:
        torch.distributed.destroy_process_group()


# -- Gaussian-mixture planes: K6 and the mixture decode -----------------------


def _gmm_params(B, P, M, seed, K=3):
    """(B, P, 3 K M) float32 mixture parameters with wide, narrow, far and
    degenerate components, a few NaN and infinite values among them."""
    g = torch.Generator().manual_seed(seed)
    p = torch.randn((B, P, 3 * K * M), generator=g)
    p[..., K * M:2 * K * M] *= 4.0                                  # means
    p[..., 2 * K * M:] = torch.exp(torch.randn((B, P, K * M), generator=g) * 2.0)  # scales
    flat = p.view(-1)
    n = flat.numel()
    for i, v in enumerate([float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 5e4, 1e-9]):
        flat[(i * 7919) % n] = v
    return p


@pytest.mark.parametrize("B,P,M", [(1, 1, 32), (2, 37, 192), (1, 768, 192)])
def test_gmm_rows_match_plain(B, P, M):
    """K6 bit for bit against ``gmm_rows_ref`` (rows, heads, the widest
    support), one launch a call; the pad rows past the elements."""
    _require_cuda()
    p = _gmm_params(B, P, M, P)
    n = P * M
    padded = -(-n // 128) * 128 + 128
    before = krans.LAUNCHES["gmm_rows"]
    w_card = torch.zeros(1, dtype=torch.int32, device="cuda")
    w_cpu = torch.zeros(1, dtype=torch.int32)
    heads, rows = krans.gmm_rows(p.cuda(), 3, padded, w_card)
    ref_heads, ref_rows = krans.gmm_rows_ref(p, 3, padded)
    krans.gmm_rows(p, 3, padded, w_cpu)
    torch.cuda.synchronize()
    assert krans.LAUNCHES["gmm_rows"] == before + 1
    assert torch.equal(heads.cpu(), ref_heads)
    assert torch.equal(rows.cpu(), ref_rows)
    _, k, nseg = krans.gmm_unpack_head(ref_heads[:, :n].long())
    assert int(w_card.item()) == int((nseg << k).max())
    assert int(w_cpu.item()) >= int(w_card.item())


@pytest.mark.parametrize("lanes,B,n_pix", [(32, 2, 40), (128, 1, 800), (256, 2, 1400)])
def test_gmm_decode_matches_plain(lanes, B, n_pix):
    """Rows from K6, K3 on the mixture planes, then the mixture decode on
    the card: bit for bit against the plain versions, equal to the coded
    symbols (escapes and each row's last segment among them), one launch
    each."""
    _require_cuda()
    M = 192
    p = _gmm_params(B, n_pix, M, lanes)
    n = n_pix * M
    T, padded, _ = dr.plane_geometry(n, lanes)
    heads, rows = krans.gmm_rows(p.cuda(), 3, padded)
    # symbols drawn from each element's first component (a few escape),
    # and four far outside every row
    g = torch.Generator().manual_seed(lanes + n)
    mu, s = (p.unflatten(-1, (3, 3, M))[:, :, i, 0].reshape(B, n) for i in (1, 2))
    mu, s = torch.nan_to_num(mu).clamp(-100, 100), torch.nan_to_num(s, nan=1.0).clamp(0.11, 100)
    sym = torch.round(mu + s * torch.randn((B, n), generator=g)).to(torch.int32)
    # every fifth symbol the first of its row's last segment (in a
    # 32-segment row, the one the search ranks past its last probe)
    lo, k, nseg = (t.cpu() for t in krans.gmm_unpack_head(heads[:, :n].long()))
    sym[:, ::5] = (lo + ((nseg - 1) << k))[:, ::5].to(torch.int32)
    sym[:, :4] = torch.tensor([31999, -31999, 30001, -30001])
    job = dr.gmm_plane(sym.cuda(), heads, rows, lanes)
    before = dict(krans.LAUNCHES)
    enc = dr.encode([job])[0]
    ref_enc = dr.encode([_cpu_job(dr.gmm_plane(sym, heads.cpu(), rows.cpu(), lanes))])[0]
    torch.cuda.synchronize()
    for k in ref_enc:
        assert torch.equal(enc[k].cpu(), ref_enc[k]), k
    assert 4 <= int(ref_enc["n_esc"].min()) and int(ref_enc["n_esc"].max()) < dr.ESC_MAX
    got = dr.gmm_decode(enc["stream"], enc["states"], heads, rows, enc["esc_pos"],
                        enc["esc_val"], lanes, n)
    want = dr.gmm_decode(*(t.cpu() for t in (enc["stream"], enc["states"], heads, rows,
                                               enc["esc_pos"], enc["esc_val"])), lanes, n)
    torch.cuda.synchronize()
    assert krans.LAUNCHES["gmm_decode"] == before["gmm_decode"] + 1
    assert krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, sym)


def _gmm_model():
    """Cheng2020-attn-gmm3 at N = 192 on seeded weights, the mixture's
    mean biases spread and its scales' bias at 1.5."""
    from hyres_tpu_torch.models import Cheng2020withCheckerboard
    from hyres_tpu_torch.nn import init_parameters

    model = init_parameters(Cheng2020withCheckerboard(192, attention=True, mixtures=3),
                            torch.Generator().manual_seed(0))
    with torch.no_grad():
        bias = model.entropy_parameters.Conv_2.Conv_0.bias
        for k, mean in enumerate((-1.5, 0.0, 1.5)):
            bias[(3 + k) * 192:(4 + k) * 192] = mean
        bias[6 * 192:] = 1.5
    return model


def test_cheng2020_gmm_roundtrip_on_card():
    """The mixture codec at N = 192 on seeded weights: symbols exact on the
    card, two K6, one K3 and two mixture decodes a roundtrip, no sync in
    the dispatch halves, and the card's payload within 0.5% of the CPU's."""
    _require_cuda()
    from hyres_tpu_torch.models import Cheng2020Codec
    from hyres_tpu_torch.utils.png import load_image

    model = _gmm_model()
    x = torch.from_numpy(load_image(IMAGE))[:, :256, :256].contiguous()
    sizes = {}
    for dev in ("cuda", "cpu"):
        codec = Cheng2020Codec(copy.deepcopy(model), coder="device", device=dev)
        codec.update()
        xd = x.to(dev)
        codec.compress(xd)  # warm-up: the wire's marks
        krans.reset_launches()
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = codec._compress_dispatch(xd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        comp = codec._compress_finish(st)
        dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
        for a, b in zip(comp["symbols"], dec["symbols"]):
            assert torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
        if dev == "cuda":
            assert {k: krans.LAUNCHES[k] for k in ("gmm_rows", "encode_planes", "gmm_decode")} \
                == {"gmm_rows": 4, "encode_planes": 1, "gmm_decode": 2}
        sizes[dev] = sum(len(b) for pl in comp["strings"][0] for b in pl)
    assert abs(sizes["cuda"] - sizes["cpu"]) <= 0.005 * sizes["cpu"]


# -- the compress's dispatch half as one CUDA graph a request key --------------

GRAPH_FAMILIES = ["hyres", "elic", "cheng2020", "cheng2020-attn-gmm3"]


def _graph_codec(family: str, graphs: bool = True):
    """A fresh device-coder codec of the family on the card; without
    ``graphs`` it runs every dispatch op by op."""
    from hyres_tpu_torch.models import Cheng2020Codec
    from hyres_tpu_torch.models.hyres import HyresCodec

    if family == "hyres":
        codec = HyresCodec.from_artifact(ARTIFACT, device="cuda", coder="device")
    elif family == "cheng2020-attn-gmm3":
        codec = Cheng2020Codec(_gmm_model(), coder="device", device="cuda")
        codec.update()
    else:
        codec = _baseline_codec(family, "cuda")
    if not graphs:
        codec._dispatch_graphs = lambda: None
    return codec


def _graph_requests(n: int):
    """n distinct 256x256 windows of the photo."""
    from hyres_tpu_torch.utils.png import load_image

    img = torch.from_numpy(load_image(IMAGE)).cuda()
    return [img[:, 128 * k:128 * k + 256, 128 * (k % 3):128 * (k % 3) + 256].contiguous()
            for k in range(n)]


def _same_payload(a: dict, b: dict) -> None:
    assert a["strings"] == b["strings"]
    assert a.get("jpeg_buffers") == b.get("jpeg_buffers")
    for s, t in zip(a["symbols"], b["symbols"]):
        assert torch.equal(torch.as_tensor(s).cpu(), torch.as_tensor(t).cpu())


def _launches():
    return {**dct.LAUNCHES, **krans.LAUNCHES}, dict(krans.LAUNCH_SHAPES)


@pytest.mark.parametrize("family", GRAPH_FAMILIES)
def test_dispatch_graph_replays_the_eager_bytes(family):
    """Three compresses of one input: op by op, capturing, replaying. Their
    strings, symbols and JFIF bytes are identical, the counters read 1 / 1
    / 1, the payload decodes exactly, and a replayed roundtrip counts the
    launches of an op-by-op one."""
    _require_cuda()
    (x,) = _graph_requests(1)
    codec, eager = _graph_codec(family), _graph_codec(family, graphs=False)
    tcodec.reset_wire_stats()
    comps = [codec.compress(x) for _ in range(3)]
    w = tcodec.WIRE_STATS
    assert (w["eager_dispatches"], w["graph_captures"], w["graph_replays"]) == (1, 1, 1)
    assert w["host_fallbacks"] == 0 and w["d2h_syncs"] == 3
    for comp in comps[1:]:
        _same_payload(comp, comps[0])
    eager.compress(x)
    counted = []
    for c in (eager, codec):
        dct.reset_launches()
        krans.reset_launches()
        out = c.inference(x)
        torch.cuda.synchronize()
        counted.append(_launches())
        _same_payload(out["compressed"], comps[0])
        for a, b in zip(out["symbols"], comps[0]["symbols"]):
            assert torch.equal(a, b)
    assert counted[1] == counted[0]
    assert tcodec.WIRE_STATS["graph_replays"] == 2


@pytest.mark.parametrize("family", GRAPH_FAMILIES)
def test_dispatch_graph_stream_equals_sequential(family):
    """inference_stream at depths 2 and 3, every compress a replay, equals
    sequential op-by-op calls bit for bit."""
    _require_cuda()
    xs = _graph_requests(4)
    codec, eager = _graph_codec(family), _graph_codec(family, graphs=False)
    for x in xs:
        codec.compress(x)  # the marks of every request
    codec.compress(xs[0])  # the capture
    seq = [eager.inference(x) for x in xs]
    tcodec.reset_wire_stats()
    for depth in (2, 3):
        outs = codec.inference_stream(xs, depth=depth)
        for a, b in zip(outs, seq):
            _same_payload(a["compressed"], b["compressed"])
            assert torch.equal(a["x_hat"], b["x_hat"])
    w = tcodec.WIRE_STATS
    assert (w["graph_replays"], w["graph_captures"], w["eager_dispatches"]) == (8, 0, 0)


@pytest.mark.parametrize("family", GRAPH_FAMILIES)
def test_dispatch_graph_miss_repulls_the_request_own_bytes(family, monkeypatch):
    """A plan below every plane's stream, captured: in a stream at depth 2
    each request misses and re-pulls from its own encoder outputs while the
    next request's replay is queued; the bytes are those op by op."""
    _require_cuda()
    xs = _graph_requests(3)
    codec, eager = _graph_codec(family), _graph_codec(family, graphs=False)
    want = [eager.compress(x) for x in xs]
    for x in xs:
        codec.compress(x)
    plan = tcodec.speculative_plan

    def low(sig, st):
        spec = plan(sig, st)
        return spec._replace(plans=tuple((lanes, 0, el) for lanes, _, el in spec.plans))

    monkeypatch.setattr(tcodec, "speculative_plan", low)
    codec.compress(xs[0])  # the lowered plan's capture
    tcodec.reset_wire_stats()
    outs = codec.inference_stream(xs, depth=2)
    w = tcodec.WIRE_STATS
    assert (w["d2h_syncs"], w["graph_replays"], w["host_fallbacks"]) == (6, 3, 0)
    for a, b in zip(outs, want):
        _same_payload(a["compressed"], b)


@pytest.mark.parametrize("family", ["hyres", "elic", "cheng2020"])
def test_dispatch_graph_host_fallback_codes_the_request_own_symbols(family, monkeypatch):
    """Every plane forced over its cap at framing: the replayed requests of a
    stream at depth 2 re-code their own symbols with the host coder, to the
    bytes of the same fallback op by op."""
    _require_cuda()
    xs = _graph_requests(3)
    codec, eager = _graph_codec(family), _graph_codec(family, graphs=False)
    for x in xs + xs:
        codec.compress(x)  # the marks of every request, then the capture

    def overflow(enc):
        raise OverflowError("forced")

    monkeypatch.setattr(tcodec.DevicePlaneCoder, "frames_from_enc", staticmethod(overflow))
    want = [eager.compress(x) for x in xs]
    tcodec.reset_wire_stats()
    outs = codec.inference_stream(xs, depth=2)
    assert tcodec.WIRE_STATS["host_fallbacks"] == 3
    assert tcodec.WIRE_STATS["graph_replays"] == 3
    for a, b in zip(outs, want):
        assert a["strings"] == b["strings"]
        assert a["compressed"].get("jpeg_buffers") == b.get("jpeg_buffers")


# -- TCM's window attention (K7) -----------------------------------------------

# the published stage shapes: g_a's first stage, SWAtten on y, h_a / h_s
K7_SHAPES = [(384, 256, 128, 8, 8), (48, 32, 128, 16, 8), (24, 16, 128, 32, 4)]


def _k7_inputs(B, H, W, C, d, p, seed=0):
    from hyres_tpu_torch.kernels import window_attn as k7

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, H, W, 3 * C), generator=g) * 2.0
    params = torch.randn((C // d, 2 * p - 1, 2 * p - 1), generator=g)
    return qkv.cuda(), k7.relative_bias(params, p).cuda()


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("H,W,C,d,p", K7_SHAPES)
def test_window_attn_matches_plain(H, W, C, d, p, shifted):
    """K7 against its plain version computed in float64 on the CPU, at the
    published stage shapes: within 2e-5 of outputs of order 1 (float32 sums
    of 64 products, taken in another order), one launch a call."""
    _require_cuda()
    from hyres_tpu_torch.kernels import window_attn as k7

    qkv, bias = _k7_inputs(1, H, W, C, d, p)
    before = k7.WINDOW_ATTN_STATS["launches"]
    got = k7.window_attention(qkv, bias, C // d, p, shifted)
    want = k7.window_attention_ref(qkv.double().cpu(), bias.double().cpu(), C // d, p, shifted)
    assert k7.WINDOW_ATTN_STATS["launches"] == before + 1
    torch.testing.assert_close(got.cpu().double(), want, rtol=0, atol=2e-5)


def test_window_attn_deterministic_and_batch_invariant():
    """Two runs are bitwise equal, and an image's output is the same alone
    as in a batch of two, W and SW."""
    _require_cuda()
    from hyres_tpu_torch.kernels import window_attn as k7

    for H, W, C, d, p in K7_SHAPES:
        qkv, bias = _k7_inputs(2, H, W, C, d, p, seed=1)
        for shifted in (False, True):
            a = k7.window_attention(qkv, bias, C // d, p, shifted)
            assert torch.equal(a, k7.window_attention(qkv, bias, C // d, p, shifted))
            one = k7.window_attention(qkv[1:].contiguous(), bias, C // d, p, shifted)
            assert torch.equal(a[1:], one)


def test_window_attn_in_a_captured_graph_equals_eager():
    _require_cuda()
    from hyres_tpu_torch.kernels import window_attn as k7

    H, W, C, d, p = K7_SHAPES[1]
    qkv, bias = _k7_inputs(1, H, W, C, d, p, seed=2)
    eager = k7.window_attention(qkv, bias, C // d, p, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            out = k7.window_attention(qkv, bias, C // d, p, True)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _tcm_codec():
    """TCM at its published widths on the card, seeded as the benchmark's
    configuration is (the blocks' joining convolutions at 0.1, the scale
    stacks' output bias at 3)."""
    from hyres_tpu_torch.models import TCM, TcmCodec
    from hyres_tpu_torch.nn import init_parameters

    model = init_parameters(TCM(), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if ".ConvTransBlock_" in k and k.endswith(".Conv_1.Conv_0.weight"):
                v.mul_(0.1)
        for i in range(model.slices):
            getattr(model, f"cc_scale_{i}").Conv_2.Conv_0.bias.fill_(3.0)
    codec = TcmCodec(model, coder="device", device="cuda")
    codec.update()
    return codec


def test_tcm_counts_its_attentions_eager_and_replayed():
    """``WINDOW_ATTN_STATS`` reads 32 launches a compress and 30 a
    decompress, op by op and when the compress's dispatch replays its
    graph; the payload decodes exactly."""
    _require_cuda()
    from hyres_tpu_torch.kernels import window_attn as k7
    from hyres_tpu_torch.utils.png import load_image

    codec = _tcm_codec()
    x = torch.from_numpy(load_image(IMAGE)).cuda()[:, :512, :768].contiguous()
    tcodec.reset_wire_stats()
    reads = []
    for _ in range(3):  # op by op, capturing, replaying
        before = k7.WINDOW_ATTN_STATS["launches"]
        comp = codec.compress(x)
        mid = k7.WINDOW_ATTN_STATS["launches"]
        dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
        reads.append((mid - before, k7.WINDOW_ATTN_STATS["launches"] - mid))
        for a, b in zip(comp["symbols"], dec["symbols"]):
            assert torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
    w = tcodec.WIRE_STATS
    assert w["graph_replays"] >= 1 and w["host_fallbacks"] == 0
    assert reads == [(32, 30)] * 3
