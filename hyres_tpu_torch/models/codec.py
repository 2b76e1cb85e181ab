"""The host and device coders, and the checkerboard family.

Counterpart of ``hyres_tpu/models/codec.py``: ``pad_to_multiple``
(shared with ``jpeg/core.py``), the host coder (the per-image stream
framing ``_frame``/``_unframe`` and the chunked host rANS
``_encode_planes``/``_decode_planes``, ``:48-160``), the device coder and
its wire, and ``CheckerboardCodec`` with its stage split
``enc_analysis``, ``dec_stage1``, ``dec_stage2``, ``dec_stage3``
(``:883-951``). Every codec serves through the one protocol of
``models/base.py CodecBase``. Beyond the reference's API, ``compress``
and ``decompress`` also return the coded and the decoded ``symbols`` (z,
then the y planes; int16 numpy arrays with the host coder, tensors on the
codec's device with the device coder), so a caller can check that a
roundtrip is exact.

Bit-exactness invariant (reference ``:890-904``): the entropy parameters
are computed by the SAME functions on both sides of the channel — the
encoder runs ``dec_stage1``/``dec_stage2`` exactly as the decoder does
and only adds the symbol quantization of its own ``y`` — so a one-ulp
difference can never flip a scale index and desync the decode. On the
card, ``utils/device.py`` keeps cuDNN deterministic and TF32 off. That
holds at the batch size the payload was coded at: cuDNN sums a batch of
one in another order than a batch of eight and moves a few scale
indexes, so one image of a batch's payload decoded alone can desync
(``scripts/torch_batch_decode.py``).

The device coder: ``DevicePlaneCoder`` (counterpart of
``TpuPlaneCoder``, reference ``:715-869``) codes a request's planes on
the card through the kernels K3-K6 (``coding/device_rans.py``): one K3
launch for every plane, and a decode (K5 for z, K4 or the mixture decode
for a y plane) between the stages. Its wire is one packed device-to-host
copy per compress in the steady state (``pull_encs_dispatch``, reference
``:339-712``: streams sliced to a codec's high-water marks, a size row
riding the blob to check the plan, a first batched call or a miss taking
one more pull; ``pack_encs`` / ``unpack_encs_host``, ``:214-274``, is its
full-cap layout), a caller's ``extra`` bytes (HyRES's JPEG coefficients)
riding it, and one host-to-device copy of every plane's frames per
decompress (``pack_frames_host`` / ``upload_frames``, ``:277-336``);
``upload_bytes`` is HyRES's second copy, of its coefficients. Both
directions go through page-locked host buffers with
``non_blocking=True``, and a compress waits on a CUDA event recorded
after its pull, never on the device as a whole.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..coding import BufferedRansEncoder, RansDecoder, RansLut
from ..coding import device_rans
from ..entropy import SYMBOL_BOUND, CdfTables, quantize_symbols_i16
from ..jpeg.core import pad_to_multiple  # noqa: F401  (the reference's name here)
from ..kernels import rans as krans
from ..nn.checkerboard import ANCHOR, NON_ANCHOR, pack, unpack
from ..utils.device import record_event, wait_event
from ..utils.trace import span
from .base import CodecBase


def _lut_for(t: CdfTables) -> RansLut:
    """O(1)-decode symbol LUT, built once per baked table set."""
    lut = getattr(t, "_lut", None)
    if lut is None:
        lut = RansLut(t.quantized_cdf, t.cdf_length)
        t._lut = lut
    return lut


@functools.lru_cache(maxsize=None)
def _coder_pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(8)


# symbols per sub-stream chunk: planes larger than this split into
# independently coded chunks so one image codes on several cores (the
# same rule as the reference, so both frame a plane alike)
_CHUNK_SYMS = 131072
_MAX_CHUNKS = max(1, min(8, os.cpu_count() or 1))


def _n_chunks(n: int) -> int:
    return max(1, min(_MAX_CHUNKS, n // _CHUNK_SYMS))


def _frame(chunks: List[bytes]) -> bytes:
    """[u8 n][u32le len]*n + payloads: the per-image stream framing."""
    head = bytes([len(chunks)]) + b"".join(
        len(c).to_bytes(4, "little") for c in chunks)
    return head + b"".join(chunks)


def _unframe(data: bytes) -> List[bytes]:
    n = data[0]
    lens = [int.from_bytes(data[1 + 4 * i: 5 + 4 * i], "little") for i in range(n)]
    out = []
    off = 1 + 4 * n
    for ln in lens:
        out.append(data[off: off + ln])
        off += ln
    return out


def _chunk_bounds(n: int, k: int) -> np.ndarray:
    return np.linspace(0, n, k + 1, dtype=np.int64)


def _enc_chunk(sym: np.ndarray, idx: np.ndarray, lo: int, hi: int, t: CdfTables) -> bytes:
    enc = BufferedRansEncoder()
    enc.encode_with_indexes(sym[lo:hi], idx[lo:hi], t.quantized_cdf, t.cdf_length,
                            t.offset)
    return enc.flush()


def _dec_chunk(data: bytes, idx: np.ndarray, lo: int, hi: int, t: CdfTables,
               lut: RansLut) -> np.ndarray:
    return RansDecoder(data).decode_stream(idx[lo:hi], t.quantized_cdf, t.cdf_length,
                                           t.offset, lut=lut)


# Every (image, chunk) task of a call is mapped over the pool as ONE flat
# level, so no task of the pool waits on another: a task that waited on
# tasks queued behind it in the same pool would deadlock once every worker
# held one (8 images of two or more chunks each).


def _map_tasks(fn, tasks: list) -> list:
    if len(tasks) == 1:
        return [fn(tasks[0])]
    return list(_coder_pool().map(fn, tasks))


def _encode_planes(symbols: np.ndarray, indexes: np.ndarray, t: CdfTables) -> List[bytes]:
    """Per-image rANS encode of (B, ...) symbol/index arrays."""
    B = symbols.shape[0]
    sym = symbols.reshape(B, -1)
    idx = indexes.reshape(B, -1)
    k = _n_chunks(sym.shape[1])
    b = _chunk_bounds(sym.shape[1], k)
    tasks = [(i, b[j], b[j + 1]) for i in range(B) for j in range(k)]
    with span("coder.encode"):
        chunks = _map_tasks(lambda a: _enc_chunk(sym[a[0]], idx[a[0]], a[1], a[2], t), tasks)
        return [_frame(chunks[i * k:(i + 1) * k]) for i in range(B)]


def _decode_planes(strings: Sequence[bytes], indexes: np.ndarray, t: CdfTables) -> np.ndarray:
    lut = _lut_for(t)
    idx = indexes.reshape(len(strings), -1)
    tasks = []  # (chunk, image, lo, hi)
    for i, data in enumerate(strings):
        chunks = _unframe(data)
        b = _chunk_bounds(idx.shape[1], len(chunks))
        tasks += [(c, i, b[j], b[j + 1]) for j, c in enumerate(chunks)]
    with span("coder.decode"):
        parts = _map_tasks(lambda a: _dec_chunk(a[0], idx[a[1]], a[2], a[3], t, lut), tasks)
    out = np.empty(idx.shape, np.int32)
    for (_, i, lo, hi), part in zip(tasks, parts):
        out[i, lo:hi] = part
    return out.reshape(indexes.shape)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# -- device coder: packed wire -------------------------------------------
#
# All coder traffic rides ONE uint8 buffer per direction. Layout of a
# compress pull, per plane:
#   [states u32 * lanes][n_renorm i32][n_esc i32]
#   [esc_pos i32 * ESC_MAX][esc_val i32 * ESC_MAX][stream u16 * cap]
# planes back to back, the caller's ``extra`` bytes last. Every section is
# a multiple of 4 bytes (lanes >= 32, caps and bucketed stream lengths are
# even), so each one views as its dtype in place.

# every transfer of the coder wire is counted here; host_fallbacks counts
# compress calls that re-framed with the host coder because a plane
# overflowed its stream cap or escape list, fallback_reasons keeps the
# OverflowError messages (most recent last); overlapped_parses counts
# HyRES decompresses whose JFIF parse ran after their device decode chain
# was queued; of the compresses on the device coder, graph_captures counts
# those that captured their dispatch half as a CUDA graph, graph_replays
# those that replayed one and eager_dispatches those that ran it op by op
# (``models/graphs.py``)
WIRE_STATS = {"d2h_bytes": 0, "d2h_syncs": 0, "h2d_bytes": 0,
              "host_fallbacks": 0, "fallback_reasons": [], "overlapped_parses": 0,
              "graph_captures": 0, "graph_replays": 0, "eager_dispatches": 0}


def reset_wire_stats() -> None:
    WIRE_STATS.update(d2h_bytes=0, d2h_syncs=0, h2d_bytes=0,
                      host_fallbacks=0, fallback_reasons=[], overlapped_parses=0,
                      graph_captures=0, graph_replays=0, eager_dispatches=0)


def count_host_fallback(exc: BaseException) -> None:
    """Record one device-coder -> host-coder fallback (keep <= 32 reasons)."""
    WIRE_STATS["host_fallbacks"] += 1
    reasons = WIRE_STATS["fallback_reasons"]
    reasons.append(str(exc))
    del reasons[:-32]


# The Gaussian-mixture coder's counters: rows that K6 built and their bytes
# (head and bounds), y symbols coded and how many of them escaped (counted
# at a compress's framing), and the widest coded support of any row, a
# device-side max that ``gmm_stats`` reads (one sync, on read only)
GMM_STATS = {"rows": 0, "row_bytes": 0, "symbols": 0, "escapes": 0, "widest_support": 0}
_GMM_WIDEST: Dict[torch.device, torch.Tensor] = {}


def reset_gmm_stats() -> None:
    GMM_STATS.update(rows=0, row_bytes=0, symbols=0, escapes=0, widest_support=0)
    for t in _GMM_WIDEST.values():
        t.zero_()


def gmm_stats() -> dict:
    """``GMM_STATS`` with the widest support read from the devices."""
    for t in _GMM_WIDEST.values():
        GMM_STATS["widest_support"] = max(GMM_STATS["widest_support"], int(t.item()))
    return dict(GMM_STATS)


def is_gmm_rows(coding) -> bool:
    """Whether a y plane's coding is a mixture's K6 rows (``gmm_rows``: a
    (heads, rows) pair), not scale indexes."""
    return isinstance(coding, tuple)


def count_gmm_planes(planes, encs) -> None:
    """Count a framed compress's mixture planes in ``GMM_STATS``: planes are
    its [(symbols, coding)], encs their pulled encoder outputs."""
    for (sym, coding), e in zip(planes, encs):
        if is_gmm_rows(coding):
            GMM_STATS["symbols"] += sym.numel()
            GMM_STATS["escapes"] += int(e["n_esc"].sum())


def _u8(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) integer tensor -> (B, nbytes) uint8 view of its bytes."""
    return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def pack_encs(encs: Sequence[Dict], extra: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder outputs (+ optional (B, ...) extra) -> (B, n) uint8, on the
    encoders' device."""
    parts = []
    for e in encs:
        parts += [_u8(e["states"]), _u8(e["n_renorm"]), _u8(e["n_esc"]),
                  _u8(e["esc_pos"]), _u8(e["esc_val"]), _u8(e["stream"])]
    if extra is not None:
        parts.append(_u8(extra))
    return torch.cat(parts, dim=1)


def _host_buffer(shape, device: torch.device) -> torch.Tensor:
    """A uint8 host buffer for the coder wire: page-locked when it crosses
    to or from a card, so the copy runs asynchronously."""
    return torch.empty(shape, dtype=torch.uint8, pin_memory=device.type == "cuda")


def pull_dispatch(blob: torch.Tensor):
    """Enqueue the one device-to-host copy of a compress into a page-locked
    buffer, with an event recorded after it. Returns (host buffer, event)."""
    if blob.device.type != "cuda":
        return blob, None
    host = _host_buffer(blob.shape, blob.device)
    host.copy_(blob, non_blocking=True)
    return host, record_event(blob.device)


def pull_finish(pending) -> np.ndarray:
    """Wait on the pull's event and view its bytes (counted)."""
    host, ev = pending
    with span("coder.pull_wait"):
        wait_event(ev)
    out = host.numpy()
    WIRE_STATS["d2h_syncs"] += 1
    WIRE_STATS["d2h_bytes"] += out.nbytes
    return out


def unpack_encs_host(blob: np.ndarray, metas: Sequence[Tuple[int, int]]):
    """(B, n) uint8 numpy blob -> (numpy encoder dicts, trailing extra
    bytes). metas: per plane (lanes, cap) in pack order."""
    off = 0

    def view(nbytes, dt):
        nonlocal off
        out = np.ascontiguousarray(blob[:, off:off + nbytes]).view(dt)
        off += nbytes
        return out

    encs = []
    for lanes, cap in metas:
        encs.append({
            "states": view(4 * lanes, np.uint32),
            "n_renorm": view(4, np.int32)[:, 0],
            "n_esc": view(4, np.int32)[:, 0],
            "esc_pos": view(4 * device_rans.ESC_MAX, np.int32),
            "esc_val": view(4 * device_rans.ESC_MAX, np.int32),
            "stream": view(2 * cap, np.uint16),
        })
    return encs, blob[:, off:]


# decode uploads and sliced pulls pad each stream to a geometric bucket
# (4096 * 2^k words) above the batch's longest, so the copy stays near the
# payload size; sparse coefficient layouts bucket their (pos, val) entries
_STREAM_BUCKET = 4096
_COEF_BUCKET = 4096


def _bucket(n: int, g: int) -> int:
    """Smallest g * 2^k >= n."""
    m = g
    while m < int(n):
        m *= 2
    return m


def pack_frames_host(unframed: Sequence[Tuple], device: torch.device = torch.device("cpu")):
    """``unframe_batch`` outputs -> ONE (B, n) uint8 host buffer
    (page-locked for a card ``device``) + per-plane (lanes, stream length)
    metas. Layout per plane: [states u32 * lanes][esc_pos i32 * ESC_MAX]
    [esc_val i32 * ESC_MAX][stream u16 * L]."""
    parts, metas = [], []
    for lanes, states, stream, esc_pos, esc_val in unframed:
        metas.append((int(lanes), int(stream.shape[1])))
        parts += [np.ascontiguousarray(a).view(np.uint8)
                  for a in (states, esc_pos.astype(np.int32),
                            esc_val.astype(np.int32), stream)]
    blob = _host_buffer((parts[0].shape[0], sum(p.shape[1] for p in parts)), device)
    np.concatenate(parts, axis=1, out=blob.numpy())
    return blob, tuple(metas)


def _upload(blob: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Enqueue the copy of a host buffer from ``_host_buffer`` (counted)."""
    WIRE_STATS["h2d_bytes"] += blob.numel()
    return blob.to(device, non_blocking=True)


def upload_bytes(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, k) uint8 numpy bytes -> the same on ``device``, through a
    page-locked buffer, enqueued without a wait behind the work already
    queued."""
    blob = _host_buffer(data.shape, device)
    np.copyto(blob.numpy(), data)
    return _upload(blob, device)


def upload_frames(unframed: Sequence[Tuple], device: torch.device):
    """ONE host-to-device copy of every plane's decode inputs, enqueued
    without a wait. Returns per plane (lanes, states int32, stream int16,
    esc_pos, esc_val) on the device."""
    with span("coder.upload"):
        blob, metas = pack_frames_host(unframed, device)
        d = _upload(blob, device)
        off = 0

        def view(nbytes, dt):
            nonlocal off
            out = d[:, off:off + nbytes].contiguous().view(dt)
            off += nbytes
            return out

        planes = []
        for lanes, L in metas:
            states = view(4 * lanes, torch.int32)
            esc_pos = view(4 * device_rans.ESC_MAX, torch.int32)
            esc_val = view(4 * device_rans.ESC_MAX, torch.int32)
            planes.append((lanes, states, view(2 * L, torch.int16), esc_pos, esc_val))
        return planes


# -- device coder: sliced pulls (reference :339-712) ----------------------
#
# A full-cap pull ships every plane at its worst-case stream cap plus the
# dense ``extra`` (1,285,400 bytes a 768x512 HyRES request).
# ``pull_encs_dispatch`` slices the blob to bucketed real lengths,
# learning them one of three ways: speculatively from a codec's
# high-water marks (the steady state: ONE pull, validated by a size row
# that rides the blob), from a dedicated size pull (a first batched
# call), or not at all (a first single-image call: full caps cost less
# than a second wait). ``extra`` rides the same blob densely, as sparse
# (pos i32, val i16) pairs, or as the active columns of its 8x8 blocks.
# Overflows show in a size row before any frame is assembled.


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _sizes_cols(encs: Sequence[Dict], extra: torch.Tensor) -> torch.Tensor:
    """(B, 2P+3) int32: per plane [n_renorm, n_esc], then the 64-bit
    block-column activity mask of ``extra`` as two int32 words (bit c set
    iff any 8x8 block's c-th coefficient is nonzero; zero when ``extra`` is
    empty or not block-aligned), then nnz(extra) last. The mask is built in
    int64 and each word wrapped to int32 explicitly, so bits 31 and 63 come
    out as the reference's uint32 words do."""
    cols = []
    for e in encs:
        cols += [e["n_renorm"], e["n_esc"]]
    flat = extra.reshape(extra.shape[0], -1)
    B, n = flat.shape
    if n and n % 64 == 0:
        bits = (flat != 0).reshape(B, n // 64, 64).any(dim=1).to(torch.int64)
        w = torch.arange(32, dtype=torch.int64, device=flat.device)
        lo = _wrap_i32((bits[:, :32] << w).sum(1))
        hi = _wrap_i32((bits[:, 32:] << w).sum(1))
    else:
        lo = hi = torch.zeros((B,), dtype=torch.int32, device=flat.device)
    cols += [lo, hi, (flat != 0).sum(1, dtype=torch.int32)]
    return torch.stack([c.to(torch.int32) for c in cols], dim=1)


def _pack_sliced(encs: Sequence[Dict], extra: torch.Tensor, slices, coef_cap,
                 with_sizes: bool = False, coef_cols=None) -> torch.Tensor:
    """``pack_encs`` with per-plane (stream_len, esc_len) slices; ``extra``
    (B, n) appended dense (``coef_cap`` None), as (pos i32, val i16) pairs
    compacted to ``coef_cap`` entries with positions padded with n, or,
    when ``coef_cols`` is a tuple of 8x8-block positions, column-sparse:
    viewed as (B, n/64, 64) with only those columns shipped (static
    slices, positions implicit). ``with_sizes`` puts the ``_sizes_cols``
    row first, so a speculative pull can check its plan from the blob."""
    parts = []
    if with_sizes:
        parts.append(_u8(_sizes_cols(encs, extra)))
    for e, (sl, el) in zip(encs, slices):
        parts += [_u8(e["states"]), _u8(e["n_renorm"]), _u8(e["n_esc"])]
        if el:
            parts += [_u8(e["esc_pos"][:, :el]), _u8(e["esc_val"][:, :el])]
        parts.append(_u8(e["stream"][:, :sl]))
    B = extra.shape[0]
    flat = extra.reshape(B, -1)
    n = flat.shape[1]
    if coef_cols is not None:
        if coef_cols:
            blk = flat.reshape(B, n // 64, 64)
            parts.append(_u8(torch.cat([blk[:, :, c:c + 1] for c in coef_cols], dim=2)))
    elif coef_cap is None:
        if n:
            parts.append(_u8(flat))
    else:
        mask = flat != 0
        iota = torch.arange(n, dtype=torch.int32, device=flat.device).expand(B, n)
        pos, _ = device_rans.masked_compact(iota, mask, coef_cap, fill=n)
        val, _ = device_rans.masked_compact(flat.to(torch.int16), mask, coef_cap)
        parts += [_u8(pos), _u8(val)]
    return torch.cat(parts, dim=1)


def _unpack_sliced_host(blob: np.ndarray, plans, extra_info, with_sizes: bool = False):
    """Inverse of ``_pack_sliced``. plans: per plane (lanes, sl, el);
    extra_info: None or (numpy dtype, per-image n, coef_cap or None[,
    coef_cols or None]). Returns (encoder dicts, dense extra or None, the
    size rows or None)."""
    off = 0
    B = blob.shape[0]

    def view(nbytes, dt):
        nonlocal off
        out = np.ascontiguousarray(blob[:, off:off + nbytes]).view(dt)
        off += nbytes
        return out

    sizes = view(4 * (2 * len(plans) + 3), np.int32) if with_sizes else None
    encs = []
    for lanes, sl, el in plans:
        encs.append({
            "states": view(4 * lanes, np.uint32),
            "n_renorm": view(4, np.int32)[:, 0],
            "n_esc": view(4, np.int32)[:, 0],
            "esc_pos": view(4 * el, np.int32) if el else np.zeros((B, 0), np.int32),
            "esc_val": view(4 * el, np.int32) if el else np.zeros((B, 0), np.int32),
            "stream": view(2 * sl, np.uint16),
        })
    extra_np = None
    if extra_info is not None:
        dt, n, coef_cap = extra_info[:3]
        coef_cols = extra_info[3] if len(extra_info) > 3 else None
        if coef_cols is not None:
            k = len(coef_cols)
            extra_np = np.zeros((B, n // 64, 64), dt)
            if k:
                packed = view(n // 64 * k * dt.itemsize, dt)
                extra_np[:, :, list(coef_cols)] = packed.reshape(B, n // 64, k)
            extra_np = extra_np.reshape(B, n)
        elif coef_cap is None:
            extra_np = view(n * dt.itemsize, dt)
        else:
            pos = view(4 * coef_cap, np.int32)
            val = view(2 * coef_cap, np.int16)
            extra_np = np.zeros((B, n), dt)
            for i in range(B):
                m = pos[i] < n
                extra_np[i, pos[i][m]] = val[i][m]
    return encs, extra_np, sizes


def _check_true_overflow(sizes: np.ndarray, caps: Sequence[int]) -> None:
    for p, cap in enumerate(caps):
        n_renorm = int(sizes[:, 2 * p].max())
        n_esc = int(sizes[:, 2 * p + 1].max())
        if n_renorm > cap or n_esc >= min(device_rans.ESC_MAX + 1, 256):
            raise OverflowError(f"plane {p}: renorm {n_renorm}/{cap} or escapes "
                                f"{n_esc} overflow")


def _exact_plans(sizes: np.ndarray, lanes_l: Sequence[int], caps: Sequence[int]):
    """Per plane (lanes, bucketed stream length, escape length): escapes
    ship as the full list or not at all."""
    plans = []
    for p, cap in enumerate(caps):
        sl = min(cap, _bucket(int(sizes[:, 2 * p].max()), _STREAM_BUCKET))
        el = 0 if int(sizes[:, 2 * p + 1].max()) == 0 else device_rans.ESC_MAX
        plans.append((lanes_l[p], sl, el))
    return plans


def pull_signature(encs: Sequence[Dict], extra: torch.Tensor | None = None) -> tuple:
    """The key of a request's marks in a codec's ``cap_state``: per plane
    (lanes, stream cap), the extra's per-image count and its numpy dtype
    string (None without an extra)."""
    lanes_caps = tuple((int(e["states"].shape[1]), int(e["stream"].shape[1])) for e in encs)
    if extra is None:
        return lanes_caps, 0, None
    dt = torch.empty(0, dtype=extra.dtype).numpy().dtype
    return lanes_caps, int(np.prod(extra.shape[1:])), dt.str


def _coef_cap(dt: np.dtype, n_extra: int, nnz_max: int):
    """(the extra's (pos, val) cap, or None where the dense bytes are
    smaller; what unpacks it)."""
    cap_nz = min(n_extra, _bucket(nnz_max, _COEF_BUCKET))
    cc = cap_nz if 6 * cap_nz < n_extra * dt.itemsize else None
    return cc, (dt, n_extra, cc)


class Speculative(NamedTuple):
    """The plan of a speculative pull, from a codec's marks: per plane
    (lanes, stream slice, escape slice); the extra's recorded 8x8 columns
    (None: not column-sparse), else its (pos, val) cap (None: dense); what
    unpacks the extra; the column mask that the blob's own is checked
    against."""

    plans: tuple
    cols: tuple | None
    coef_cap: int | None
    extra_info: tuple | None
    colmask: int


def speculative_plan(sig: tuple, st: dict) -> Speculative:
    """The speculative pull of a request of signature ``sig`` (see
    ``pull_signature``) from its marks ``st``: streams sliced to hwm * 5/4
    + 512 in 4096-word buckets, escapes whole or not at all, the extra as
    its recorded active 8x8 columns when block-aligned, else as (pos, val)
    pairs or dense."""
    lanes_caps, n_extra, dtstr = sig
    plans = tuple((lanes, min(cap, _bucket(st["streams"][p] * 5 // 4 + 512, _STREAM_BUCKET)),
                   0 if st["escs"][p] == 0 else device_rans.ESC_MAX)
                  for p, (lanes, cap) in enumerate(lanes_caps))
    if dtstr is None:
        return Speculative(plans, None, None, None, 0)
    dt = np.dtype(dtstr)
    if n_extra % 64 == 0 and "colmask" in st:
        cm = st["colmask"]
        cols = tuple(c for c in range(64) if (cm >> c) & 1)
        return Speculative(plans, cols, None, (dt, n_extra, None, cols), cm)
    cc, extra_info = _coef_cap(dt, n_extra, st["nnz"] * 5 // 4 + 64)
    return Speculative(plans, None, cc, extra_info, 0)


def _extra_rows(encs: Sequence[Dict], extra: torch.Tensor | None) -> torch.Tensor:
    """``extra`` as (B, n) rows; (B, 0) without one."""
    B = int(encs[0]["states"].shape[0])
    if extra is None:
        return torch.zeros((B, 0), dtype=torch.uint8, device=encs[0]["states"].device)
    return extra.reshape(B, -1)


def pack_speculative(encs: Sequence[Dict], extra: torch.Tensor | None,
                     spec: Speculative) -> torch.Tensor:
    """The device blob of a speculative pull: the size row first, then the
    planes sliced by ``spec`` and the extra in its layout."""
    slices = [(sl, el) for _, sl, el in spec.plans]
    return _pack_sliced(encs, _extra_rows(encs, extra), slices, spec.coef_cap,
                        with_sizes=True, coef_cols=spec.cols)


def pull_encs_dispatch(encs: Sequence[Dict], extra: torch.Tensor | None = None,
                       cap_state: dict | None = None, packed: torch.Tensor | None = None):
    """Enqueue the pack and the pull of a compress without a wait; returns a
    ``finish()`` that waits on the pull and unpacks it into (numpy encoder
    dicts, ``extra`` as a dense numpy array shaped like it, or None).
    ``finish()`` raises OverflowError when a plane overflowed its stream
    cap or escape list (the caller re-frames with the host coder).

    The plan (reference ``pull_encs_dispatch``):

    - ``cap_state`` holds high-water marks for this plane signature ->
      SPECULATIVE single pull (``speculative_plan``), the size row first;
      a miss re-pulls once with exact slices.
    - first call, B == 1 -> one full-cap pull (``pack_encs``).
    - first call, B >= 2 -> a size pull, then an exactly sliced blob.

    ``cap_state`` is a per-codec dict (updated here) keyed by the plane
    signature (``pull_signature``), so each shape keeps its own marks.
    ``packed`` is the speculative blob of the plan that ``cap_state``
    gives, packed already (a replayed CUDA graph's, ``models/graphs.py``);
    ``encs`` and ``extra`` are still read by a miss's re-pull."""
    B = int(encs[0]["states"].shape[0])
    encs = list(encs)
    extra_arr = _extra_rows(encs, extra)
    sig = pull_signature(encs, extra)
    lanes_l = [lanes for lanes, _ in sig[0]]
    caps = [cap for _, cap in sig[0]]
    n_extra = sig[1]
    dt = None if extra is None else np.dtype(sig[2])
    st = None if cap_state is None else cap_state.get(sig)

    def mask_of(sizes) -> int:
        """The column mask OR'd over the batch (columns -3/-2 of a size
        row); 0 when not block-aligned."""
        lo = np.bitwise_or.reduce(sizes[:, -3].astype(np.uint32))
        hi = np.bitwise_or.reduce(sizes[:, -2].astype(np.uint32))
        return int(lo) | (int(hi) << 32)

    def finalize(out, extra_np, sizes):
        if cap_state is not None:
            prev = cap_state.get(sig) or {"streams": [0] * len(encs),
                                          "escs": [0] * len(encs), "nnz": 0, "colmask": 0}
            cap_state[sig] = {
                "streams": [max(prev["streams"][p], int(sizes[:, 2 * p].max()))
                            for p in range(len(encs))],
                "escs": [max(prev["escs"][p], int(sizes[:, 2 * p + 1].max()))
                         for p in range(len(encs))],
                "nnz": max(prev["nnz"], int(sizes[:, -1].max())),
                "colmask": prev.get("colmask", 0) | mask_of(sizes),
            }
        if extra is not None:
            extra_np = np.ascontiguousarray(extra_np).view(dt).reshape(
                (B,) + tuple(extra.shape[1:]))
        return out, extra_np

    def exact_repull(sizes):
        _check_true_overflow(sizes, caps)
        plans = _exact_plans(sizes, lanes_l, caps)
        cc, extra_info = ((None, None) if extra is None
                          else _coef_cap(dt, n_extra, int(sizes[:, -1].max())))
        with span("coder.pull"):
            pending = pull_dispatch(
                _pack_sliced(encs, extra_arr, [(sl, el) for _, sl, el in plans], cc))
        blob = pull_finish(pending)
        out, extra_np, _ = _unpack_sliced_host(blob, plans, extra_info)
        return finalize(out, extra_np, sizes)

    if st is not None:
        spec = speculative_plan(sig, st)
        with span("coder.pull"):
            pending = pull_dispatch(pack_speculative(encs, extra, spec) if packed is None
                                    else packed)

        def finish():
            out, extra_np, sizes = _unpack_sliced_host(pull_finish(pending), spec.plans,
                                                       spec.extra_info, with_sizes=True)
            _check_true_overflow(sizes, caps)
            fits = all(int(sizes[:, 2 * p].max()) <= sl and int(sizes[:, 2 * p + 1].max()) <= el
                       for p, (_, sl, el) in enumerate(spec.plans)) and (
                (mask_of(sizes) | spec.colmask) == spec.colmask if spec.cols is not None
                else (spec.coef_cap is None or int(sizes[:, -1].max()) <= spec.coef_cap))
            if fits:
                return finalize(out, extra_np, sizes)
            return exact_repull(sizes)  # the marks were passed: one more pull
        return finish

    if B == 1:
        with span("coder.pull"):
            pending = pull_dispatch(pack_encs(encs, extra_arr if n_extra else None))

        def finish():
            out, extra_bytes = unpack_encs_host(pull_finish(pending),
                                                list(zip(lanes_l, caps)))
            # the size row for the marks, from the pulled fields themselves
            nnz, lo, hi = 0, 0, 0
            if extra is not None:
                flat = np.ascontiguousarray(extra_bytes).view(dt)
                nnz = int((flat != 0).sum(axis=1).max())
                if n_extra and n_extra % 64 == 0:
                    colnz = (flat != 0).reshape(flat.shape[0], -1, 64).any(axis=(0, 1))
                    cm = sum(1 << c for c in range(64) if colnz[c])
                    lo = np.uint32(cm & 0xFFFFFFFF).astype(np.int32)
                    hi = np.uint32(cm >> 32).astype(np.int32)
            sizes = np.stack(
                [c for e in out for c in (e["n_renorm"], e["n_esc"])]
                + [np.full(B, lo, np.int32), np.full(B, hi, np.int32),
                   np.full(B, nnz, np.int32)], axis=1)
            return finalize(out, None if extra is None else extra_bytes, sizes)
        return finish

    with span("coder.pull"):
        pending = pull_dispatch(_u8(_sizes_cols(encs, extra_arr)))

    def finish():
        return exact_repull(pull_finish(pending).view(np.int32))
    return finish


def pull_encs(encs: Sequence[Dict], extra: torch.Tensor | None = None,
              cap_state: dict | None = None):
    """Dispatch and finish in one call (the pull without pipelining)."""
    return pull_encs_dispatch(encs, extra, cap_state)()


class DevicePlaneCoder:
    """Device-side rANS coder bound to one baked table set.

    Gaussian (y) planes code against the segment tables built from the
    scale table (64 x 128 bounds plus uniform low bits); Gaussian-mixture
    (y) planes against one row an element that K6 builds from the stage's
    mixture parameters (``gmm_rows``); factorized-prior (z) planes against
    the baked per-channel CDFs. A y plane's coding (scale indexes or K6
    rows) picks its job and its decode (``job``, ``decode``). All planes
    of a batch (HyRES's three, ELIC's eleven) encode in ONE K3 launch
    (``device_rans.encode``); each decode (K4, K5 or the mixture decode)
    is its own launch between the entropy-parameter stages, which both
    sides of the channel compute with the same functions (the
    bit-exactness invariant).
    """

    def __init__(self, eb_tables: CdfTables, scale_table, device: torch.device):
        self.gauss = device_rans.build_gauss_tables(scale_table).to(device)
        self.eb = device_rans.build_device_tables(eb_tables).to(device)

    @staticmethod
    def _y_lanes(n: int) -> int:
        return min(device_rans.GAUSS_LANES, device_rans.lanes_for(n))

    @staticmethod
    def _z_idx(shape, device) -> torch.Tensor:
        C = shape[-1]
        return torch.arange(C, dtype=torch.int32, device=device).expand(shape)

    def gauss_job(self, sym, idx) -> device_rans.PlaneJob:
        """The encode job of one gaussian (y) plane of (B, ...) symbols and
        scale rows, at min(GAUSS_LANES, lanes_for(n)) lanes."""
        B = sym.shape[0]
        return device_rans.gauss_plane(sym.reshape(B, -1), idx.reshape(B, -1),
                                       self.gauss, self._y_lanes(sym[0].numel()))

    def eb_job(self, z_sym) -> device_rans.PlaneJob:
        """The encode job of the factorized-prior (z) plane of NHWC symbols,
        at lanes_for(n) lanes."""
        B = z_sym.shape[0]
        z_idx = self._z_idx(z_sym.shape, z_sym.device)
        return device_rans.eb_plane(z_sym.reshape(B, -1), z_idx.reshape(B, -1),
                                    self.eb, device_rans.lanes_for(z_sym[0].numel()))

    def job(self, sym, coding) -> device_rans.PlaneJob:
        """The encode job of one y plane against its coding."""
        if is_gmm_rows(coding):
            return self.gmm_job(sym, coding)
        return self.gauss_job(sym, coding)

    def decode(self, u, coding, shape):
        """One y plane, as ``upload_frames`` gives it, against its coding ->
        int16 symbols of NHWC ``shape``."""
        lanes, states, stream, esc_pos, esc_val = u
        if is_gmm_rows(coding):
            return self.decode_gmm(stream, states, coding, esc_pos, esc_val, lanes, shape)
        return self.decode_gauss(stream, states, coding, esc_pos, esc_val, lanes)

    # -- Gaussian-mixture (y) planes: one row an element ---------------------

    def gmm_rows(self, params: torch.Tensor, K: int):
        """(B, ..., 3 K M) packed mixture parameters of one parity -> the
        plane's rows (heads, rows) from K6, padded to the plane's lanes."""
        B, C = params.shape[0], params.shape[-1]
        n = params[0].numel() // (3 * K)
        _, padded, _ = device_rans.plane_geometry(n, self._y_lanes(n))
        dev = params.device
        if dev not in _GMM_WIDEST:
            with torch.inference_mode(False):  # reset_gmm_stats zeroes it outside
                _GMM_WIDEST[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        with span("coder.gmm_rows"):
            rows = krans.gmm_rows(params.reshape(B, -1, C).contiguous(), K, padded,
                                  _GMM_WIDEST[dev])
        GMM_STATS["rows"] += B * padded
        GMM_STATS["row_bytes"] += B * padded * (2 * krans.GMM_SEGMENTS + 4)
        return rows

    def gmm_job(self, sym, rows) -> device_rans.PlaneJob:
        """The encode job of one mixture plane of (B, ...) symbols and its
        ``gmm_rows``."""
        B = sym.shape[0]
        return device_rans.gmm_plane(sym.reshape(B, -1), *rows, self._y_lanes(sym[0].numel()))

    def decode_gmm(self, stream, states, rows, esc_pos, esc_val, lanes: int, shape):
        """Mixture plane of NHWC ``shape`` and its ``gmm_rows`` -> int16
        symbols."""
        with span("coder.decode"):
            sym = device_rans.gmm_decode(stream, states, *rows, esc_pos, esc_val, lanes,
                                         int(np.prod(shape[1:])))
            sym = torch.clamp(sym, -SYMBOL_BOUND, SYMBOL_BOUND).to(torch.int16)
        return sym.reshape(shape)

    def decode_gauss(self, stream, states, idx, esc_pos, esc_val, lanes: int):
        """Gaussian plane -> int16 symbols shaped like ``idx``."""
        B = idx.shape[0]
        with span("coder.decode"):
            sym = device_rans.gauss_decode(stream, states, idx.reshape(B, -1),
                                           esc_pos, esc_val, self.gauss, lanes,
                                           idx[0].numel())
            sym = torch.clamp(sym, -SYMBOL_BOUND, SYMBOL_BOUND).to(torch.int16)
        return sym.reshape(idx.shape)

    def decode_eb(self, stream, states, esc_pos, esc_val, shape, lanes: int):
        """Factorized-prior plane of NHWC ``shape`` -> int16 symbols."""
        B = shape[0]
        with span("coder.decode"):
            idx = self._z_idx(shape, states.device).reshape(B, -1)
            sym = device_rans.eb_decode(stream, states, idx, esc_pos, esc_val,
                                        self.eb, lanes, idx.shape[1])
            return torch.clamp(sym, -SYMBOL_BOUND, SYMBOL_BOUND).to(torch.int16).reshape(shape)

    # -- host-side (un)framing ---------------------------------------------

    @staticmethod
    def frames_from_enc(enc) -> List[bytes]:
        """Per-image frames from downloaded (numpy) encoder outputs. Raises
        OverflowError if any image overflowed its stream cap or escape
        list (the caller re-frames the whole batch with the host coder)."""
        with span("coder.frame"):
            return [device_rans.frame_plane(
                enc["states"][i], enc["stream"][i], int(enc["n_renorm"][i]),
                enc["esc_pos"][i], enc["esc_val"][i], int(enc["n_esc"][i]))
                for i in range(enc["states"].shape[0])]

    @staticmethod
    def unframe_batch(strings: Sequence[bytes], n: int):
        """Per-image frames -> stacked (lanes, states, stream, esc_pos,
        esc_val) numpy arrays, streams zero-padded to a common bucketed
        length; None if any frame is host-coder framed or the lanes
        differ."""
        if not all(device_rans.is_device_frame(s) for s in strings):
            return None
        with span("coder.unframe"):
            parts = [device_rans.unframe_plane(s, n) for s in strings]
            lanes = parts[0][0]
            if any(p[0] != lanes for p in parts):
                return None
            L = _bucket(max(p[2].shape[0] for p in parts), _STREAM_BUCKET)
            stream = np.zeros((len(parts), L), np.uint16)
            for i, p in enumerate(parts):
                stream[i, : p[2].shape[0]] = p[2]
            return (lanes, np.stack([p[1] for p in parts]), stream,
                    np.stack([p[3] for p in parts]), np.stack([p[4] for p in parts]))


class CheckerboardCodec(CodecBase):
    """Model + baked CDF tables; host or device rANS coder.

    clamp: output range of decompress (None for a signed residual, as
    HyresCodec uses it). ``symbols`` are (z, anchor, non-anchor).
    """

    # -- stages shared by both sides of the channel ------------------------

    @torch.inference_mode()
    def enc_analysis(self, x: torch.Tensor):
        """Padded NHWC x -> (y float32, z symbols int16)."""
        with span("model.analysis"):
            y, z = self.model.analysis(x)
            return y, quantize_symbols_i16(z, self.model.eb_medians())

    @torch.inference_mode()
    def dec_stage1(self, z_sym: torch.Tensor, y: torch.Tensor | None = None):
        """z symbols -> (latent params, anchor indexes u8, anchor means,
        anchor symbols of ``y`` or None on the decoder side)."""
        with span("model.params"):
            z_hat = z_sym.to(torch.float32) + self.model.eb_medians()
            lp = self.model.hyper_synthesis(z_hat)
            sa, ma = self.model.anchor_params(lp)
            ma_p = pack(ma, ANCHOR)
            a_idx = self._indexes(pack(sa, ANCHOR))
            a_sym = None if y is None else quantize_symbols_i16(pack(y, ANCHOR), ma_p)
            return lp, a_idx, ma_p, a_sym

    @torch.inference_mode()
    def dec_stage2(self, lp, a_sym, ma_p, y: torch.Tensor | None = None):
        """Anchor symbols -> (y_anchor_hat, non-anchor indexes, means,
        non-anchor symbols of ``y`` or None)."""
        with span("model.params"):
            y_anchor_hat = unpack(a_sym.to(ma_p.dtype) + ma_p, ANCHOR)
            sn, mn = self.model.nonanchor_params(lp, y_anchor_hat)
            mn_p = pack(mn, NON_ANCHOR)
            n_idx = self._indexes(pack(sn, NON_ANCHOR))
            n_sym = None if y is None else quantize_symbols_i16(pack(y, NON_ANCHOR), mn_p)
            return y_anchor_hat, n_idx, mn_p, n_sym

    def y_hat(self, y_anchor_hat, n_sym, mn_p) -> torch.Tensor:
        return y_anchor_hat + unpack(n_sym.to(mn_p.dtype) + mn_p, NON_ANCHOR)

    @torch.inference_mode()
    def dec_stage3(self, y_anchor_hat, n_sym, mn_p) -> torch.Tensor:
        with span("model.synthesis"):
            x_hat = self.model.synthesis(self.y_hat(y_anchor_hat, n_sym, mn_p))
            if self.clamp is not None:
                x_hat = torch.clamp(x_hat, self.clamp[0], self.clamp[1])
            return x_hat

    # -- the family's part of the protocol (models/base.py) -----------------

    def _chain(self, z_sym, code, y=None):
        """Stage 1, the anchor plane, stage 2, the non-anchor plane."""
        lp, a_idx, ma_p, a_sym = self.dec_stage1(z_sym, y)
        y_anchor_hat, n_idx, mn_p, n_sym = self.dec_stage2(lp, code(a_idx, a_sym), ma_p, y)
        return y_anchor_hat, code(n_idx, n_sym), mn_p

    def _synthesis(self, chained) -> torch.Tensor:
        return self.dec_stage3(*chained)

    def _y_planes(self, shape):
        return [(4 * shape[0], 2 * shape[1], self.model.M)] * 2  # packed half-width
