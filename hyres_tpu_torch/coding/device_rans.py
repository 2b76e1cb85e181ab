"""Device-side lane-parallel rANS coder: tables, splits, planes, framing.

Counterpart of ``hyres_tpu/coding/tpu_rans.py``. The coder's two
directions run on the card, so the whole decode chain (z, hyper
parameters, anchor, context, non-anchor, synthesis) is one asynchronous
chain of device work with one host synchronisation at its end, and a
compress pulls everything it needs from the card in one copy.

Construction (the same wire as the JAX package, byte for byte):

* interleaved multi-lane rANS: a 32-bit state per lane in [2^16, 2^32),
  16-bit renormalisation words, 16-bit quantized CDFs;
* one renorm stream per plane shared by its lanes: on each step the lanes
  that renormalise read (decode) or wrote (encode) consecutive words in
  lane order;
* a flat plane of n symbols is laid out (T, lanes), flat index
  i -> (i // lanes, i % lanes), the tail padded;
* factorized-prior (z) planes code against the baked per-channel CDF rows
  (``build_device_tables``); gaussian (y) planes against segment tables
  plus k uniform low bits (``build_gauss_tables``); Gaussian-mixture (y)
  planes the same way against one row an element (``gmm_plane``, the rows
  from K6, ``kernels/rans.py gmm_rows``), every quantity exact integer
  arithmetic;
* out-of-support symbols code the row's escape bin in-stream and carry
  their value in a side list of at most ``ESC_MAX`` (position, value)
  pairs; a plane that needs more, or whose renorm words exceed its stream
  cap, raises ``OverflowError`` at framing and the codec re-frames the
  batch with the host coder.

Frame of one plane (``frame_plane``/``unframe_plane``):
  [u8 0x80|lanes_log2][u8 n_esc][u32 n_renorm]
  [lanes * u32 final states][n_renorm * u16][n_esc * (u32 pos, i16 val)]

The scans themselves are the kernels of ``kernels/rans.py`` (K3 encode,
K4 gaussian decode, K5 factorized decode). The JAX module's environment
knobs choose among TPU lowerings; the port has one lowering and takes
their defaults as constants.

Tensors: symbols, table rows and states are int32 (states and stream
words keep their u32/u16 bits in int32/int16 tensors); frames and the
host side are numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import rans as krans

RENORM_BASE = krans.RENORM_BASE
ESC_MAX = krans.ESC_MAX  # side-list capacity; more escapes -> host fallback
DEFAULT_LANES = 256
Z_LANES = 64
GAUSS_B = krans.GAUSS_B  # value-slot budget; [GAUSS_B, 2^16) is the escape bin
GAUSS_ESC_FREQ = 65536 - GAUSS_B
SUPPORT_SIGMAS = 6.0   # the baked tables' 1e-9 tail multiplier
GAUSS_COLS = 128       # bounds row width: at most 127 segments
GAUSS_LANES = 128      # lanes of a y plane
TPU_MAGIC = 0x80       # first frame byte 0x80|lanes_log2; the host coder's
                       # chunked framing starts with a chunk count <= 8


@dataclass(frozen=True)
class DeviceCoderTables:
    """Factorized-prior coding tables (counterpart of ``TpuCoderTables``).

    bounds: (rows, maxL+1) CDF bounds, 2^17 past each row's end;
    start/freq: (rows, maxL) bin starts and widths (0 past the end);
    offset: (rows,) value of bin 0; maxv: (rows,) the escape bin's index.
    """

    bounds: torch.Tensor
    start: torch.Tensor
    freq: torch.Tensor
    offset: torch.Tensor
    maxv: torch.Tensor
    pad_symbol: int

    def to(self, device) -> "DeviceCoderTables":
        return _tables_to(self, device)


@dataclass(frozen=True)
class GaussTables:
    """Segment tables of the gaussian coder.

    bounds: (rows, GAUSS_COLS) strictly increasing quantized CDF bounds at
    bin edges (j << k), bounds[0] = 0, bounds[nseg] = GAUSS_B, 65536 past
    nseg; params: (rows, 4) [c, L, k, nseg].
    """

    bounds: torch.Tensor
    params: torch.Tensor

    def to(self, device) -> "GaussTables":
        return _tables_to(self, device)


def _tables_to(t, device):
    return replace(t, **{f.name: getattr(t, f.name).to(device)
                         for f in fields(t)
                         if isinstance(getattr(t, f.name), torch.Tensor)})


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def build_device_tables(t) -> DeviceCoderTables:
    """CdfTables (host numpy) -> factorized-prior coding tables (CPU)."""
    cdf = np.asarray(t.quantized_cdf, np.int64)
    lengths = np.asarray(t.cdf_length, np.int64)
    offsets = np.asarray(t.offset, np.int64)
    rows, max_len = cdf.shape
    for r in range(rows):
        if np.diff(cdf[r, : lengths[r]]).max() > 0xFFFF:
            raise ValueError(f"row {r}: degenerate full-range CDF bin")
    freqs0 = np.diff(cdf[0, : lengths[0]])
    pad_symbol = int(np.argmax(freqs0[:-1]) + offsets[0])  # skip escape bin
    start = np.zeros((rows, max_len), np.int64)
    freq = np.zeros((rows, max_len), np.int64)
    bounds = np.full((rows, max_len + 1), 1 << 17, np.int64)
    for r in range(rows):
        nbins = lengths[r] - 1
        start[r, :nbins] = cdf[r, :nbins]
        freq[r, :nbins] = np.diff(cdf[r, : lengths[r]])
        bounds[r, : lengths[r]] = cdf[r, : lengths[r]]
    return DeviceCoderTables(bounds=_i32(bounds), start=_i32(start),
                             freq=_i32(freq), offset=_i32(offsets),
                             maxv=_i32(lengths - 2), pad_symbol=pad_symbol)


def build_gauss_tables(scale_table) -> GaussTables:
    """Per scale row (float64, scipy): support half-width c = ceil(6 sigma),
    L = 2c+1 bins, the smallest k with ceil(L / 2^k) <= 127 segments, and
    the bounds of the quantized CDF at the segment edges, lifted so every
    segment keeps at least one slot."""
    from scipy.special import ndtr

    st = np.asarray(scale_table, np.float64)
    rows = st.size
    bounds = np.full((rows, GAUSS_COLS), 65536, np.int64)
    params = np.zeros((rows, 4), np.int64)
    for r in range(rows):
        c = int(np.ceil(SUPPORT_SIGMAS * st[r]))
        L = 2 * c + 1
        k = 0
        while -(-L // (1 << k)) > GAUSS_COLS - 1:
            k += 1
        nseg = -(-L // (1 << k))
        edges = np.minimum(np.arange(nseg + 1) << k, L).astype(np.float64)
        lo = ndtr((-c - 0.5) / st[r])
        den = ndtr((c + 0.5) / st[r]) - lo
        F = (ndtr((edges - c - 0.5) / st[r]) - lo) / den
        b = np.floor(GAUSS_B * np.clip(F, 0.0, 1.0))
        f = np.maximum(np.diff(b).astype(np.int64), 1)
        excess = int(f.sum()) - GAUSS_B
        while excess > 0:
            g = int(np.argmax(f))
            take = min(excess, int(f[g]) - 1)
            f[g] -= take
            excess -= take
        if excess != 0 or (f < 1).any():
            raise ValueError(f"scale row {r}: no valid segment table")
        bounds[r, : nseg + 1] = np.concatenate([[0], np.cumsum(f)])
        params[r] = [c, L, k, nseg]
    return GaussTables(bounds=_i32(bounds), params=_i32(params))


# -- geometry ------------------------------------------------------------


def lanes_for(n: int) -> int:
    """Lanes for an n-symbol plane: enough to keep the scan short, few
    enough that the per-lane state flush (4 bytes a lane) stays ~1% of a
    typical plane's payload."""
    lanes = 32
    while lanes < 256 and n >= lanes * 1024:
        lanes *= 2
    return lanes


def plane_geometry(n: int, lanes: int) -> Tuple[int, int, int]:
    """(T, padded_n, n_max renorm entries) for an n-symbol plane."""
    T = -(-n // lanes)
    return T, T * lanes, T * lanes


def stream_cap(n: int, lanes: int, words: int = 1) -> int:
    """Renorm-stream buffer entries: the worst case (``words`` per symbol)
    for planes up to 65536 symbols, an average of 4 bits a symbol above."""
    _, padded, _ = plane_geometry(n, lanes)
    if n <= 65536:
        return padded * words
    return max(4096, padded // 4)


def to_tl(flat: torch.Tensor, T: int, lanes: int, pad_value: int) -> torch.Tensor:
    """(B, n) -> (B, T, lanes) int32, the tail padded with ``pad_value``."""
    B, n = flat.shape
    flat = flat.to(torch.int32)
    if T * lanes != n:
        flat = torch.nn.functional.pad(flat, (0, T * lanes - n), value=pad_value)
    return flat.reshape(B, T, lanes)


# -- per-symbol coding parameters (bulk, exact) ----------------------------


def eb_split(sym: torch.Tensor, idx: torch.Tensor, t: DeviceCoderTables):
    """Factorized-prior (start, freq, esc) per symbol; int32 inputs of any
    shape, table rows ``idx``."""
    row = idx.long()
    off = t.offset[row]
    maxv = t.maxv[row]
    v = sym.to(torch.int32) - off
    esc = (v < 0) | (v >= maxv)
    flat = row * t.start.shape[1] + torch.where(esc, maxv, v).long()
    return t.start.reshape(-1)[flat], t.freq.reshape(-1)[flat], esc


def gauss_split(sym: torch.Tensor, idx: torch.Tensor, gt: GaussTables):
    """Gaussian (start_h, freq_h, low, 16 - k, esc) per symbol: the symbol's
    bin v = sym + c splits into the segment h = v >> k, coded against the
    bounds, and k uniform low bits. Escapes code the escape bin and k zero
    low bits."""
    row = idx.long()
    prm = gt.params[row]
    c, L, k = prm[..., 0], prm[..., 1], prm[..., 2]
    v = sym.to(torch.int32) + c
    esc = (v < 0) | (v >= L)
    vv = torch.where(esc, torch.zeros_like(v), v)
    h = vv >> k
    low = vv - (h << k)
    flat = row * gt.bounds.shape[1] + h.long()
    b = gt.bounds.reshape(-1)
    b0, b1 = b[flat], b[flat + 1]
    start = torch.where(esc, torch.full_like(b0, GAUSS_B), b0)
    freq = torch.where(esc, torch.full_like(b0, GAUSS_ESC_FREQ), b1 - b0)
    return start, freq, low, 16 - k, esc


def gmm_split(sym: torch.Tensor, heads: torch.Tensor, rows: torch.Tensor):
    """Mixture (start_h, freq_h, low, 16 - k, esc) per symbol, as
    ``gauss_split`` with the element's own row: heads (...) and rows (...,
    GMM_SEGMENTS) from ``kernels/rans.py gmm_rows``. A symbol outside the
    row's nseg << k symbols from lo escapes."""
    lo, k, nseg = krans.gmm_unpack_head(heads)
    v = sym.to(torch.int32) - lo
    esc = (v < 0) | (v >= nseg << k)
    vv = torch.where(esc, torch.zeros_like(v), v)
    h = (vv >> k).long()
    low = vv - (h.to(torch.int32) << k)
    b = rows.to(torch.int32) & 0xFFFF
    b1 = torch.gather(b, -1, h.clamp(max=krans.GMM_SEGMENTS - 1)[..., None])[..., 0]
    b0 = torch.gather(b, -1, (h - 1).clamp(min=0)[..., None])[..., 0]
    b0 = torch.where(h > 0, b0, torch.zeros_like(b0))
    start = torch.where(esc, torch.full_like(b0, GAUSS_B), b0)
    freq = torch.where(esc, torch.full_like(b0, GAUSS_ESC_FREQ), b1 - b0)
    return start, freq, low, 16 - k, esc


def gmm_stream_cap(n: int, lanes: int) -> int:
    """Stream words of a mixture plane: the worst case (two words a symbol)
    up to 65536 symbols, an average of 8 bits a symbol above."""
    _, padded, _ = plane_geometry(n, lanes)
    return 2 * padded if n <= 65536 else max(4096, padded // 2)


# -- planes --------------------------------------------------------------


class PlaneJob(NamedTuple):
    """One plane's encode: the kernel's inputs plus what framing needs."""

    plane: krans.EncodePlane
    esc: torch.Tensor    # (B, padded) bool
    sym: torch.Tensor    # (B, padded) int32, padded symbols
    lanes: int


def gauss_plane(sym_b: torch.Tensor, idx_b: torch.Tensor, gt: GaussTables,
                lanes: int) -> PlaneJob:
    """(B, n) gaussian symbols and scale rows -> encode job (two pushes a
    symbol, so the small-plane stream budget is 2 words a symbol)."""
    B, n = sym_b.shape
    T, padded, _ = plane_geometry(n, lanes)
    sym = to_tl(sym_b, T, lanes, 0)      # pad: the row-0 centre symbol
    idx = to_tl(idx_b, T, lanes, 0)
    start, freq, low, ks, esc = gauss_split(sym, idx, gt)
    plane = krans.EncodePlane(start, freq, low, ks, stream_cap(n, lanes, 2))
    return PlaneJob(plane, esc.reshape(B, padded), sym.reshape(B, padded), lanes)


def eb_plane(sym_b: torch.Tensor, idx_b: torch.Tensor, t: DeviceCoderTables,
             lanes: int) -> PlaneJob:
    """(B, n) factorized-prior symbols and CDF rows -> encode job (the low
    push is the identity: ks = 16, low = 0)."""
    B, n = sym_b.shape
    T, padded, _ = plane_geometry(n, lanes)
    sym = to_tl(sym_b, T, lanes, t.pad_symbol)
    idx = to_tl(idx_b, T, lanes, 0)
    start, freq, esc = eb_split(sym, idx, t)
    plane = krans.EncodePlane(start, freq, torch.zeros_like(start),
                              torch.full_like(start, 16), stream_cap(n, lanes))
    return PlaneJob(plane, esc.reshape(B, padded), sym.reshape(B, padded), lanes)


def gmm_plane(sym_b: torch.Tensor, heads: torch.Tensor, rows: torch.Tensor,
              lanes: int) -> PlaneJob:
    """(B, n) mixture symbols and their rows ((B, padded) heads, (B,
    padded, GMM_SEGMENTS) rows, padded past n with the pad row) -> encode
    job."""
    B, n = sym_b.shape
    T, padded, _ = plane_geometry(n, lanes)
    if heads.shape != (B, padded):
        raise ValueError(f"gmm_plane: {tuple(heads.shape)} rows for a plane of "
                         f"({B}, {padded})")
    sym = to_tl(sym_b, T, lanes, 0)  # pad: the pad row's symbol 0
    start, freq, low, ks, esc = gmm_split(sym, heads.reshape(B, T, lanes),
                                          rows.reshape(B, T, lanes, -1))
    plane = krans.EncodePlane(start, freq, low, ks, gmm_stream_cap(n, lanes))
    return PlaneJob(plane, esc.reshape(B, padded), sym.reshape(B, padded), lanes)


def escape_lists(sym: torch.Tensor, esc: torch.Tensor):
    """(B, padded) symbols and escape mask -> ((B, ESC_MAX) positions in
    ascending order, padded past the count; their values; (B,) exact
    count). No host synchronisation: fixed-size compaction."""
    B, padded = esc.shape
    pos = torch.stack([
        torch.nonzero_static(esc[b], size=ESC_MAX, fill_value=padded)[:, 0]
        for b in range(B)]).to(torch.int32)
    val = torch.gather(sym, 1, pos.clamp(max=padded - 1).long()).to(torch.int32)
    return pos, val, esc.sum(1, dtype=torch.int32)


def masked_compact(vals: torch.Tensor, mask: torch.Tensor, cap: int, fill=0):
    """Row-wise stable compaction (counterpart of ``tpu_rans.masked_compact``):
    (B, n) values and mask -> ((B, cap) the values at the mask's set
    positions in order, ``fill`` past the count; (B,) int32 count). No
    host synchronisation: a set element's slot is its rank, a cumulative
    sum, and the scatter sends every unset element, and every set one
    past ``cap``, to an extra slot that is dropped."""
    B, _ = vals.shape
    rank = torch.cumsum(mask, 1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < cap), rank, cap).long()
    out = torch.full((B, cap + 1), fill, dtype=vals.dtype, device=vals.device)
    out.scatter_(1, slot, vals)
    return out[:, :cap], mask.sum(1, dtype=torch.int32)


def encode(jobs: Sequence[PlaneJob]) -> List[Dict[str, torch.Tensor]]:
    """All planes in ONE K3 launch -> per plane the encoder outputs:
    states (B, lanes), stream (B, cap) int16 in decoder read order from
    offset 0, n_renorm (B,), esc_pos/esc_val (B, ESC_MAX), n_esc (B,)."""
    outs = krans.encode_planes([j.plane for j in jobs])
    encs = []
    for j, (stream, states, n_renorm) in zip(jobs, outs):
        esc_pos, esc_val, n_esc = escape_lists(j.sym, j.esc)
        encs.append({"states": states, "stream": stream, "n_renorm": n_renorm,
                     "esc_pos": esc_pos, "esc_val": esc_val, "n_esc": n_esc})
    return encs


def gauss_decode(stream, states, idx_b, esc_pos, esc_val, gt: GaussTables,
                 lanes: int, n: int) -> torch.Tensor:
    """(B, S) stream, (B, lanes) states, (B, n) scale rows and the escape
    lists -> (B, n) int32 symbols (K4)."""
    T, _, _ = plane_geometry(n, lanes)
    sym = krans.gauss_decode(to_tl(idx_b, T, lanes, 0), gt.bounds, gt.params,
                             stream, states, esc_pos, esc_val)
    return sym[:, :n]


def gmm_decode(stream, states, heads, rows, esc_pos, esc_val, lanes: int,
               n: int) -> torch.Tensor:
    """(B, S) stream, (B, lanes) states, the plane's rows ((B, padded)
    heads, (B, padded, GMM_SEGMENTS) rows) and the escape lists -> (B, n)
    int32 symbols."""
    B = heads.shape[0]
    T, _, _ = plane_geometry(n, lanes)
    sym = krans.gmm_decode(heads.reshape(B, T, lanes), rows.reshape(B, T, lanes, -1),
                           stream, states, esc_pos, esc_val)
    return sym[:, :n]


def eb_decode(stream, states, idx_b, esc_pos, esc_val, t: DeviceCoderTables,
              lanes: int, n: int) -> torch.Tensor:
    """Factorized-prior counterpart of ``gauss_decode`` (K5)."""
    T, _, _ = plane_geometry(n, lanes)
    sym = krans.eb_decode(to_tl(idx_b, T, lanes, 0), t.bounds, t.offset,
                          stream, states, esc_pos, esc_val)
    return sym[:, :n]


# -- the reference's entry points (``tpu_rans`` names and argument order) --
#
# Thin calls of the above: a JAX user's code finds the same functions, and
# the outputs keep ``tpu_rans``'s dict keys. ``gauss_decode`` above is
# already batched, so the reference's single-plane ``gauss_decode`` is
# ``gauss_decode_batch`` on a batch of one here.


def fused_encode_planes(planes) -> List[Dict[str, torch.Tensor]]:
    """``("gauss"|"eb", sym_b, idx_b, tables, lanes)`` tuples -> one output
    dict a plane, every plane in ONE K3 launch."""
    make = {"gauss": gauss_plane, "eb": eb_plane}
    return encode([make[kind](sym_b, idx_b, tab, lanes)
                   for kind, sym_b, idx_b, tab, lanes in planes])


def gauss_encode_batch(sym_b: torch.Tensor, idx_b: torch.Tensor, gt: GaussTables,
                       lanes: int) -> Dict[str, torch.Tensor]:
    """(B, n) gaussian symbols and scale rows -> one K3 launch's outputs."""
    return fused_encode_planes([("gauss", sym_b, idx_b, gt, lanes)])[0]


def rans_encode_batch(sym_b: torch.Tensor, idx_b: torch.Tensor, tables: DeviceCoderTables,
                      lanes: int) -> Dict[str, torch.Tensor]:
    """(B, n) factorized-prior symbols and CDF rows -> one K3 launch's
    outputs."""
    return fused_encode_planes([("eb", sym_b, idx_b, tables, lanes)])[0]


gauss_decode_batch = gauss_decode  # K4
rans_decode_batch = eb_decode      # K5


def _first(enc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v[0] for k, v in enc.items()}


def gauss_encode(symbols: torch.Tensor, indexes: torch.Tensor, gt: GaussTables,
                 lanes: int) -> Dict[str, torch.Tensor]:
    """One flat (n,) gaussian plane: ``gauss_encode_batch`` on a batch of
    one, the outputs without the batch axis."""
    return _first(gauss_encode_batch(symbols[None], indexes[None], gt, lanes))


def rans_encode(symbols: torch.Tensor, indexes: torch.Tensor, tables: DeviceCoderTables,
                lanes: int) -> Dict[str, torch.Tensor]:
    """One flat (n,) factorized-prior plane (``rans_encode_batch``)."""
    return _first(rans_encode_batch(symbols[None], indexes[None], tables, lanes))


def rans_decode(stream, states, indexes, esc_pos, esc_val, tables: DeviceCoderTables,
                lanes: int, n: int) -> torch.Tensor:
    """One plane's stream, states, (n,) rows and escape lists -> (n,)
    int32 symbols (``rans_decode_batch``)."""
    return rans_decode_batch(stream[None], states[None], indexes[None], esc_pos[None],
                             esc_val[None], tables, lanes, n)[0]


def escape_compact(sym_flat: torch.Tensor, esc_flat: torch.Tensor, fill_pos: int):
    """(n,) symbols and escape mask -> ((ESC_MAX,) int32 positions in
    ascending order, ``fill_pos`` past the count; their values, 0 past
    the count; the exact count), by ``masked_compact``. No host
    synchronisation."""
    mask = esc_flat.to(torch.bool)[None]
    pos = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)[None]
    esc_pos, n_esc = masked_compact(pos, mask, ESC_MAX, fill=fill_pos)
    esc_val, _ = masked_compact(sym_flat.to(torch.int32)[None], mask, ESC_MAX)
    return esc_pos[0], esc_val[0], n_esc[0]


# -- host framing ----------------------------------------------------------


def is_device_frame(data: bytes) -> bool:
    return len(data) > 0 and data[0] >= TPU_MAGIC


def frame_plane(states: np.ndarray, stream: np.ndarray, n_renorm: int,
                esc_pos: np.ndarray, esc_val: np.ndarray, n_esc: int) -> bytes:
    """One plane's bytes from the downloaded encoder outputs (u32/u16 bits
    in any integer dtype)."""
    lanes = states.shape[0]
    lanes_log2 = int(lanes).bit_length() - 1
    if 1 << lanes_log2 != lanes:
        raise ValueError(f"lanes {lanes} is not a power of two")
    # n_esc rides a one-byte header field: 256 fits the side list but not
    # the header, so it overflows to the host coder too
    if n_esc >= min(ESC_MAX + 1, 256):
        raise OverflowError(f"{n_esc} escapes exceed side-list cap {ESC_MAX}")
    if n_renorm > stream.shape[0]:
        raise OverflowError(
            f"{n_renorm} renorm chunks exceed the stream cap {stream.shape[0]}")
    vals = np.asarray(esc_val[:n_esc], np.int64)
    if vals.size and (vals.min() < -32768 or vals.max() > 32767):
        raise OverflowError(f"escape value {int(vals[np.abs(vals).argmax()])} "
                            "exceeds i16")
    head = (bytes([TPU_MAGIC | lanes_log2, int(n_esc)])
            + int(n_renorm).to_bytes(4, "little"))
    body = (np.asarray(states).astype("<u4").tobytes()
            + np.asarray(stream[:n_renorm]).astype("<u2").tobytes())
    esc = np.zeros(int(n_esc), dtype=[("pos", "<u4"), ("val", "<i2")])
    esc["pos"] = np.asarray(esc_pos[:n_esc]).astype("<u4")
    esc["val"] = vals
    return head + body + esc.tobytes()


def unframe_plane(data: bytes, n: int):
    """bytes -> (lanes, states u32, exact-length stream u16 (at least one
    entry), esc_pos (ESC_MAX,) int32 padded past n_esc, esc_val)."""
    lanes = 1 << (data[0] & 0x7F)
    n_esc = data[1]
    n_renorm = int.from_bytes(data[2:6], "little")
    off = 6
    states = np.frombuffer(data, "<u4", lanes, off).copy()
    off += 4 * lanes
    _, padded, _ = plane_geometry(n, lanes)
    stream = np.zeros(max(n_renorm, 1), np.uint16)
    stream[:n_renorm] = np.frombuffer(data, "<u2", n_renorm, off)
    off += 2 * n_renorm
    esc = np.frombuffer(data, [("pos", "<u4"), ("val", "<i2")], n_esc, off)
    esc_pos = np.full(ESC_MAX, padded, np.int32)
    esc_val = np.zeros(ESC_MAX, np.int32)
    esc_pos[:n_esc] = esc["pos"]
    esc_val[:n_esc] = esc["val"]
    return lanes, states, stream, esc_pos, esc_val
