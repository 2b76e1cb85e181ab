"""Lane-parallel rANS scans: CUDA kernels K3, K4 and K5.

Replace the Pallas TPU kernels of ``hyres_tpu/coding/pallas_rans.py``:
``_encode_call`` (``_encode_kernel``, K3), ``_decode_call``
(``_decode_kernel``, K4) and ``_eb_decode_call`` (``_eb_decode_kernel``,
K5). The kernels are in ``csrc/rans.cu`` (built by ``kernels/build.py``,
bound with ctypes); the plain PyTorch versions sit beside them as
``*_ref``: Python loops over time, vectorised over lanes and images, the
XLA scans of ``hyres_tpu/coding/tpu_rans.py`` (``gauss_encode``,
``rans_encode``, ``gauss_decode``, ``rans_decode``) computed in int64.

Dispatch is by the tensors' device: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (never plain-version calls), ``LAUNCH_SHAPES`` the same launches
by their planes' lanes.

Layouts (torch has no u32/u16 arithmetic, so the bits ride in signed
tensors): per-step inputs and table rows (B, T, lanes) int32; states
(B, lanes) int32 holding u32 bits; streams int16 holding u16 words;
escape lists (B, 256) int32, positions in the padded flat (T * lanes)
layout, positions >= T * lanes ignored.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

LAUNCHES = {"encode_planes": 0, "gauss_decode": 0, "eb_decode": 0, "gmm_rows": 0,
            "gmm_decode": 0}
# launches by shape: (kernel, the lanes of each plane) for K3, (kernel,
# lanes) for K4 and K5
LAUNCH_SHAPES: collections.Counter = collections.Counter()

# constants of the wire, shared with coding/device_rans.py and csrc/rans.cu
RENORM_BASE = 1 << 16  # lane states live in [2^16, 2^32)
GAUSS_B = 65504        # gaussian value-slot budget; [GAUSS_B, 2^16) escapes
ESC_MAX = 256          # escape side-list capacity
_MAX_PLANES = 16  # csrc/rans.cu kMaxPlanes
_MAX_LANES = 256

# K6's rows (csrc/rans.cu kGmm*): a row is GMM_SEGMENTS u16 cumulative
# bounds, a head (lo + 32768) | k << 16 | nseg << 20
GMM_SEGMENTS = 32
GMM_FX = 4096           # fixed point of means and scales
GMM_LOGIT_FX = 256      # fixed point of logit differences
GMM_EXP_LEN = 3072      # EXP[d] = round(2^16 exp(-d / 256)), 0 from d ~ 3019
GMM_PHI_T = 8           # the Phi table spans [-8, 8] in steps of 1/256
GMM_PHI_LEN = 2 * GMM_PHI_T * 256 + 1
GMM_T_BITS = 12         # fractional bits of a standardized segment edge
GMM_TAIL_Q = 1564       # 6.109 * 256: -ndtri(1e-9 / 2), the tables' tail
GMM_SCALE_MIN = 0.11
GMM_SCALE_MAX = 32000.0
GMM_LOGIT_MAX = 1e4
GMM_SYMBOL_BOUND = 32000
GMM_PAD_HEAD = 32768 | (1 << 20)  # symbol 0 alone, one segment


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


class EncodePlane(NamedTuple):
    """One plane of an encode: per step and lane the high push's start and
    freq, the low bits and 16 - k, each (B, T, lanes) int32, and the
    stream buffer's capacity in words."""

    start: torch.Tensor
    freq: torch.Tensor
    low: torch.Tensor
    ks: torch.Tensor
    cap: int


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^16) -> int16 with the same bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


# -- plain versions ----------------------------------------------------------


def _encode_plane_ref(p: EncodePlane):
    B, T, lanes = p.start.shape
    start, freq, low, ks = (x.to(torch.int64) for x in p[:4])
    state = torch.full((B, lanes), RENORM_BASE, dtype=torch.int64,
                       device=start.device)
    emit = torch.empty((B, T, 2, lanes), dtype=torch.int64, device=start.device)
    need = torch.empty((B, T, 2, lanes), dtype=torch.bool, device=start.device)
    for t in range(T - 1, -1, -1):
        # push low (k uniform bits; ks = 16 is the identity)
        k = ks[:, t]
        freq_l = torch.ones_like(k) << k
        nl = (state >> 16) >= freq_l
        emit[:, t, 1], need[:, t, 1] = state & 0xFFFF, nl
        state = torch.where(nl, state >> 16, state)
        state = ((state >> k) << 16) + (low[:, t] << k) + (state & (freq_l - 1))
        # push high
        f = freq[:, t]
        nh = (state >> 16) >= f
        emit[:, t, 0], need[:, t, 0] = state & 0xFFFF, nh
        state = torch.where(nh, state >> 16, state)
        state = ((state // f) << 16) + state % f + start[:, t]
    # decoder read order: step ascending, [high, low], lane ascending; on
    # overflow the buffer keeps the last `cap` words, as the kernel does
    need = need.reshape(B, -1)
    emit = emit.reshape(B, -1)
    n_renorm = need.sum(1)
    stream = torch.zeros((B, p.cap), dtype=torch.int64, device=start.device)
    for b in range(B):
        words = emit[b][need[b]][-p.cap:]
        stream[b, : words.numel()] = words
    return _u16_bits(stream), _u32_bits(state), n_renorm.to(torch.int32)


def encode_planes_ref(planes: Sequence[EncodePlane]):
    """Plain version of K3; same contract as ``encode_planes``."""
    return [_encode_plane_ref(p) for p in planes]


def _renorm_ref(state, ptr, words):
    """One renorm round: lanes with state < 2^16 read the next words in
    lane order (reads past the buffer's end give 0)."""
    S = words.shape[1]
    need = state < RENORM_BASE
    rank = torch.cumsum(need, 1) - need.long()
    pos = ptr[:, None] + rank
    read = torch.where(pos < S, torch.gather(words, 1, pos.clamp(max=S - 1)), 0)
    state = torch.where(need, (state << 16) | read, state)
    return state, ptr + need.sum(1)


def _decode_ref(gauss: bool, idx, bounds, aux, stream, states, esc_pos, esc_val):
    B, T, lanes = idx.shape
    rows, cols = bounds.shape
    bounds = bounds.to(torch.int64)
    aux = aux.to(torch.int64)
    words = stream.to(torch.int64) & 0xFFFF
    state = states.to(torch.int64) & 0xFFFFFFFF
    ptr = torch.zeros(B, dtype=torch.int64, device=idx.device)
    out = torch.empty((B, T, lanes), dtype=torch.int64, device=idx.device)
    for t in range(T):
        row = idx[:, t].long().clamp(0, rows - 1)
        rowvals = bounds[row]                              # (B, lanes, cols)
        slot = state & 0xFFFF
        # the bin is the rank of the slot among the row's bounds
        v = (rowvals <= slot[..., None]).sum(-1) - 1
        b0 = torch.gather(rowvals, 2, v[..., None])[..., 0]
        b1 = torch.gather(rowvals, 2, (v + 1).clamp(max=cols - 1)[..., None])[..., 0]
        if gauss:
            esc = slot >= GAUSS_B
            start = torch.where(esc, GAUSS_B, b0)
            freq = torch.where(esc, RENORM_BASE, b1) - start
            v = torch.where(esc, 0, v)
        else:
            start, freq = b0, b1 - b0
        state = freq * (state >> 16) + slot - start
        state, ptr = _renorm_ref(state, ptr, words)
        if gauss:
            c, k = aux[row, 0], aux[row, 2]
            ks = 16 - k
            slot2 = state & 0xFFFF
            lowv = slot2 >> ks
            state = ((state >> 16) << ks) + (slot2 & ((torch.ones_like(ks) << ks) - 1))
            state, ptr = _renorm_ref(state, ptr, words)
            out[:, t] = ((v << k) | lowv) - c
        else:
            out[:, t] = v + aux[row]
    out = out.reshape(B, T * lanes)
    # substitute escaped values from the side list (padding positions drop)
    ok = (esc_pos >= 0) & (esc_pos < T * lanes)
    rows_b = torch.arange(B, device=idx.device)[:, None].expand_as(esc_pos)
    out[rows_b[ok], esc_pos[ok].long()] = esc_val[ok].to(torch.int64)
    return out.to(torch.int32)


@functools.lru_cache(maxsize=None)
def gmm_phi_table() -> torch.Tensor:
    """(GMM_PHI_LEN,) int32 on the CPU: round(2^28 Phi(t)) at t = -8 + i / 256."""
    t = torch.arange(GMM_PHI_LEN, dtype=torch.float64) / 256.0 - GMM_PHI_T
    return torch.round(torch.special.ndtr(t) * (1 << 28)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def gmm_exp_table() -> torch.Tensor:
    """(GMM_EXP_LEN,) int32 on the CPU: round(2^16 exp(-d / 256))."""
    d = torch.arange(GMM_EXP_LEN, dtype=torch.float64)
    return torch.round(torch.exp(-d / GMM_LOGIT_FX) * 65536.0).to(torch.int32)


def gmm_unpack_head(head: torch.Tensor):
    """-> (lo, k, nseg) of row heads."""
    return (head & 0xFFFF) - 32768, (head >> 16) & 0xF, (head >> 20) & 0x3F


def _gmm_fixed(params: torch.Tensor, K: int):
    """(n_pix, 3 K M) float32 -> (e, mq, sq), each (n_pix * M, K) int64."""
    M = params.shape[-1] // (3 * K)
    l, mu, s = (t.transpose(-1, -2).reshape(-1, K)
                for t in params.unflatten(-1, (3, K, M)).unbind(-3))
    l = torch.clamp(torch.nan_to_num(l, nan=0.0), -GMM_LOGIT_MAX, GMM_LOGIT_MAX)
    mu = torch.clamp(torch.nan_to_num(mu, nan=0.0), -float(GMM_SYMBOL_BOUND),
                     float(GMM_SYMBOL_BOUND))
    s = torch.clamp(torch.nan_to_num(s, nan=GMM_SCALE_MIN), GMM_SCALE_MIN, GMM_SCALE_MAX)
    d = torch.round((l.amax(1, keepdim=True) - l) * float(GMM_LOGIT_FX)).to(torch.int64)
    e = gmm_exp_table().to(l.device).long()[d.clamp(0, GMM_EXP_LEN - 1)]
    mq = torch.round(mu * float(GMM_FX)).to(torch.int64)
    sq = torch.round(s * float(GMM_FX)).to(torch.int64)
    return e, mq, sq


def _gmm_phi(u: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Phi at t = u / 2^12 (int64), linear between the table's points."""
    span = GMM_PHI_T << GMM_T_BITS
    u = u.clamp(-span, span) + span
    i, f = u >> 4, u & 15
    a = table[i]
    b = table[(i + 1).clamp(max=GMM_PHI_LEN - 1)]
    return a + (((b - a) * f) >> 4)


def gmm_rows_ref(params: torch.Tensor, K: int, padded: int):
    """Plain version of K6; same contract as ``gmm_rows``."""
    B, P, C = params.shape
    n = P * (C // (3 * K))
    dev = params.device
    heads = torch.full((B, padded), GMM_PAD_HEAD, dtype=torch.int32, device=dev)
    rows = torch.full((B, padded, GMM_SEGMENTS), -1, dtype=torch.int16, device=dev)
    rows[:, :, 0] = GAUSS_B - 65536
    if n == 0:
        return heads, rows
    e, mq, sq = _gmm_fixed(params.reshape(B * P, C), K)
    on = e > 0
    lo_k = (mq * 256 - GMM_TAIL_Q * sq) >> 20  # floor((mq - 6.109 sq) / 4096)
    hi_k = -((-(mq * 256 + GMM_TAIL_Q * sq)) >> 20)
    big = 1 << 40
    lo = torch.where(on, lo_k, big).amin(1).clamp(-GMM_SYMBOL_BOUND, GMM_SYMBOL_BOUND)
    hi = torch.where(on, hi_k, -big).amax(1).clamp(-GMM_SYMBOL_BOUND, GMM_SYMBOL_BOUND)
    L = torch.maximum(hi, lo) - lo + 1
    k = torch.zeros_like(L)
    while True:
        wide = (L + (1 << k) - 1) >> k > GMM_SEGMENTS
        if not bool(wide.any()):
            break
        k = k + wide.long()
    nseg = (L + (1 << k) - 1) >> k
    j = torch.arange(GMM_SEGMENTS + 1, device=dev)
    x = (lo[:, None] + (j[None] << k[:, None])) * GMM_FX - GMM_FX // 2  # segment edges
    r = (1 << 40) // sq                                                  # 2^40 / sq
    u = ((x[:, :, None] - mq[:, None, :]) * r[:, None, :]) >> 28         # t * 2^12
    F = (e[:, None, :] * _gmm_phi(u, gmm_phi_table().to(dev).long())).sum(2)
    den = torch.gather(F, 1, nseg[:, None]) - F[:, :1]
    num = torch.minimum(torch.clamp(F - F[:, :1], min=0), den.clamp(min=0))
    b = torch.where(den > 0, num * GAUSS_B // den.clamp(min=1),
                    GAUSS_B * j[None] // nseg[:, None])
    live = j[None, :GMM_SEGMENTS] < nseg[:, None]
    f = torch.where(live, torch.clamp(b[:, 1:] - b[:, :-1], min=1), 0)
    excess = f.sum(1) - GAUSS_B  # at most nseg: taken from the first widest
    f = f - torch.nn.functional.one_hot(torch.argmax(f, 1), GMM_SEGMENTS) * excess[:, None]
    cum = torch.where(live, torch.cumsum(f, 1), 0xFFFF)
    heads[:, :n] = ((lo + 32768) | (k << 16) | (nseg << 20)).to(torch.int32).reshape(B, n)
    rows[:, :n] = _u16_bits(cum).reshape(B, n, GMM_SEGMENTS)
    return heads, rows


def gmm_decode_ref(heads, rows, stream, states, esc_pos, esc_val):
    """Plain version of the mixture decode; same contract as ``gmm_decode``."""
    B, T, lanes = heads.shape
    words = stream.to(torch.int64) & 0xFFFF
    state = states.to(torch.int64) & 0xFFFFFFFF
    ptr = torch.zeros(B, dtype=torch.int64, device=heads.device)
    out = torch.empty((B, T, lanes), dtype=torch.int64, device=heads.device)
    for t in range(T):
        lo, k, _ = gmm_unpack_head(heads[:, t].to(torch.int64))
        row = rows[:, t].to(torch.int64) & 0xFFFF               # (B, lanes, 32)
        slot = state & 0xFFFF
        esc = slot >= GAUSS_B
        h = (row <= slot[..., None]).sum(-1)
        h = torch.where(esc, 0, h).clamp(max=GMM_SEGMENTS - 1)
        b1 = torch.gather(row, 2, h[..., None])[..., 0]
        b0 = torch.where(h > 0, torch.gather(row, 2, (h - 1).clamp(min=0)[..., None])[..., 0], 0)
        start = torch.where(esc, GAUSS_B, b0)
        freq = torch.where(esc, RENORM_BASE, b1) - start
        state = freq * (state >> 16) + slot - start
        state, ptr = _renorm_ref(state, ptr, words)
        ks = 16 - k
        slot2 = state & 0xFFFF
        lowv = slot2 >> ks
        state = ((state >> 16) << ks) + (slot2 & ((torch.ones_like(ks) << ks) - 1))
        state, ptr = _renorm_ref(state, ptr, words)
        out[:, t] = lo + ((h << k) | lowv)
    out = out.reshape(B, T * lanes)
    ok = (esc_pos >= 0) & (esc_pos < T * lanes)
    rows_b = torch.arange(B, device=heads.device)[:, None].expand_as(esc_pos)
    out[rows_b[ok], esc_pos[ok].long()] = esc_val[ok].to(torch.int64)
    return out.to(torch.int32)


def gauss_decode_ref(idx, bounds, params, stream, states, esc_pos, esc_val):
    """Plain version of K4; same contract as ``gauss_decode``."""
    return _decode_ref(True, idx, bounds, params, stream, states, esc_pos, esc_val)


def eb_decode_ref(idx, bounds, offset, stream, states, esc_pos, esc_val):
    """Plain version of K5; same contract as ``eb_decode``."""
    return _decode_ref(False, idx, bounds, offset, stream, states, esc_pos, esc_val)


# -- kernels -----------------------------------------------------------------


class _EncPlaneC(ctypes.Structure):
    """``HykEncPlane`` of csrc/rans.cu."""

    _fields_ = [("start", ctypes.c_void_p), ("freq", ctypes.c_void_p),
                ("low", ctypes.c_void_p), ("ks", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("states", ctypes.c_void_p),
                ("n_renorm", ctypes.c_void_p), ("work", ctypes.c_void_p),
                ("T", ctypes.c_int32), ("lanes", ctypes.c_int32),
                ("cap", ctypes.c_int32), ("B", ctypes.c_int32),
                ("first_block", ctypes.c_int32)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("rans")
    lib.hyk_rans_encode.argtypes = [ctypes.POINTER(_EncPlaneC), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.hyk_rans_encode.restype = ctypes.c_int
    lib.hyk_rans_encode_work.argtypes = [ctypes.c_int] * 3
    lib.hyk_rans_encode_work.restype = ctypes.c_int64
    lib.hyk_rans_decode.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.hyk_rans_decode.restype = ctypes.c_int
    lib.hyk_rans_decode_smem.argtypes = [ctypes.c_int] * 4
    lib.hyk_rans_decode_smem.restype = ctypes.c_int
    lib.hyk_divmod_check.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.hyk_divmod_check.restype = ctypes.c_int
    lib.hyk_gmm_rows.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p] * 6)
    lib.hyk_gmm_rows.restype = ctypes.c_int
    lib.hyk_gmm_decode.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
    lib.hyk_gmm_decode.restype = ctypes.c_int
    lib.hyk_gmm_decode_smem.argtypes = [ctypes.c_int]
    lib.hyk_gmm_decode_smem.restype = ctypes.c_int
    return lib


def _check(name: str, device: torch.device, **tensors) -> None:
    for arg, (t, dtype, ndim) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} must be on {device}, got {t.device}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: {arg} must be {ndim}-D {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_lanes(name: str, lanes: int) -> None:
    if lanes % 32 or not 32 <= lanes <= _MAX_LANES:
        raise ValueError(f"{name}: lanes must be a multiple of 32 in "
                         f"[32, {_MAX_LANES}], got {lanes}")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def encode_planes(planes: Sequence[EncodePlane]
                  ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """K3: reverse-time rANS encode of every plane (at most 16), in one
    launch (one CTA per plane and image, one warp per 32 lanes). Returns per plane (stream
    (B, cap) int16 in decoder read order from offset 0, zero past
    n_renorm; final states (B, lanes) int32; n_renorm (B,) int32, the
    exact word count). A plane whose words exceed its cap keeps its last
    ``cap`` words; nothing is written outside the buffer."""
    if not planes:
        return []
    # the plain version refuses what the kernel refuses
    if len(planes) > _MAX_PLANES:
        raise ValueError(f"encode_planes: at most {_MAX_PLANES} planes a launch")
    device = planes[0].start.device
    if device.type == "cpu":
        return encode_planes_ref(planes)
    shapes = [tuple(p.start.shape) for p in planes]
    for p, shape in zip(planes, shapes):
        if len(shape) != 3:
            raise ValueError(f"encode_planes: inputs must be (B, T, lanes), got {shape}")
        _check("encode_planes", device,
               **{f: (getattr(p, f), torch.int32, 3) for f in ("start", "freq", "low", "ks")})
        if any(getattr(p, f).shape != p.start.shape for f in ("freq", "low", "ks")):
            raise ValueError("encode_planes: a plane's inputs differ in shape")
        _check_lanes("encode_planes", shape[2])
        if not 0 < p.cap < 1 << 30 or shape[0] * shape[1] * shape[2] >= 1 << 30:
            raise ValueError(f"encode_planes: plane too large ({shape}, cap {p.cap})")
    # K3 copies its inputs 16 bytes at a time
    planes = [p._replace(**{f: getattr(p, f).clone() for f in ("start", "freq", "low", "ks")
                            if getattr(p, f).data_ptr() % 16})
              for p in planes]
    # one buffer per output kind: the planes' regions sit back to back
    n_words = sum(s[0] * p.cap for s, p in zip(shapes, planes))
    stream = torch.empty(n_words, dtype=torch.int16, device=device)
    states = torch.empty(sum(s[0] * s[2] for s in shapes), dtype=torch.int32,
                         device=device)
    n_renorm = torch.empty(sum(s[0] for s in shapes), dtype=torch.int32,
                           device=device)
    lib = _lib()
    # K3 work buffer: per plane and image, staging streams and word counts
    work_bytes = [B * lib.hyk_rans_encode_work(T, lanes, p.cap)
                     for p, (B, T, lanes) in zip(planes, shapes)]
    work = torch.empty(sum(work_bytes), dtype=torch.uint8, device=device)
    descs = (_EncPlaneC * len(planes))()
    outs = []
    o_s = o_st = o_n = o_x = 0
    for d, p, (B, T, lanes), nx in zip(descs, planes, shapes, work_bytes):
        s = stream[o_s:o_s + B * p.cap].view(B, p.cap)
        st = states[o_st:o_st + B * lanes].view(B, lanes)
        nr = n_renorm[o_n:o_n + B]
        d.start, d.freq, d.low, d.ks = (getattr(p, f).data_ptr()
                                        for f in ("start", "freq", "low", "ks"))
        d.stream, d.states, d.n_renorm = s.data_ptr(), st.data_ptr(), nr.data_ptr()
        d.work = work.data_ptr() + o_x
        d.T, d.lanes, d.cap, d.B = T, lanes, p.cap, B
        outs.append((s, st, nr))
        o_s, o_st, o_n, o_x = o_s + B * p.cap, o_st + B * lanes, o_n + B, o_x + nx
    max_lanes = max(s[2] for s in shapes)
    with torch.cuda.device(device):
        cs = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hyk_rans_encode(descs, len(planes), max_lanes, cs)
    _raise_on("encode_planes", rc)
    LAUNCHES["encode_planes"] += 1
    LAUNCH_SHAPES["encode_planes", tuple(s[2] for s in shapes)] += 1
    return outs


def _decode(name: str, gauss: bool, idx, bounds, aux, stream, states,
            esc_pos, esc_val) -> torch.Tensor:
    device = idx.device
    B, T, lanes = idx.shape
    _check(name, device, idx=(idx, torch.int32, 3),
           bounds=(bounds, torch.int32, 2), aux=(aux, torch.int32, aux.dim()),
           stream=(stream, torch.int16, 2), states=(states, torch.int32, 2),
           esc_pos=(esc_pos, torch.int32, 2), esc_val=(esc_val, torch.int32, 2))
    _check_lanes(name, lanes)
    if B * T * lanes >= 1 << 30:
        raise ValueError(f"{name}: plane too large ({B}, {T}, {lanes})")
    rows, cols = bounds.shape
    aux_stride = aux.shape[1] if aux.dim() == 2 else 1
    if (aux.shape[0] != rows or (gauss and aux_stride < 3)
            or stream.shape[0] != B or stream.shape[1] < 1
            or states.shape != (B, lanes)
            or esc_pos.shape != (B, ESC_MAX) or esc_val.shape != (B, ESC_MAX)):
        raise ValueError(f"{name}: inconsistent shapes")
    if gauss and cols > 255:
        raise ValueError(f"{name}: at most 255 bounds a row, got {cols}")
    if _lib().hyk_rans_decode_smem(int(gauss), rows, cols, lanes) > 227 * 1024:
        raise ValueError(f"{name}: table ({rows}, {cols}) exceeds shared memory")
    if idx.data_ptr() % 16:
        idx = idx.clone()  # the kernels read a thread's rows 8 or 16 bytes at a time
    out = torch.empty((B, T * lanes), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        cs = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().hyk_rans_decode(
            int(gauss), idx.data_ptr(), bounds.data_ptr(), aux.data_ptr(),
            aux_stride, rows, cols, stream.data_ptr(), stream.shape[1],
            states.data_ptr(), esc_pos.data_ptr(), esc_val.data_ptr(),
            out.data_ptr(), B, T, lanes, cs)
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name, lanes] += 1
    return out


def gauss_decode(idx, bounds, params, stream, states, esc_pos, esc_val):
    """K4: forward decode of segment-table gaussian planes. idx (B, T,
    lanes) int32 scale rows; bounds (rows, 128) and params (rows, 4)
    [c, L, k, nseg] int32; stream (B, S) int16; states (B, lanes) int32;
    escape lists (B, 256) int32 -> (B, T * lanes) int32 symbols."""
    if idx.device.type == "cpu":
        return gauss_decode_ref(idx, bounds, params, stream, states, esc_pos, esc_val)
    return _decode("gauss_decode", True, idx, bounds, params, stream, states,
                   esc_pos, esc_val)


def eb_decode(idx, bounds, offset, stream, states, esc_pos, esc_val):
    """K5: forward decode of factorized-prior planes against CDF rows
    (bounds (rows, maxL+1) int32, 2^17 past each row's end; offset (rows,)
    int32); other arguments as ``gauss_decode``. Any number of bounds a
    row: the kernel narrows its search with a rank LUT where the table
    fits one in shared memory, and searches the whole row otherwise."""
    if idx.device.type == "cpu":
        return eb_decode_ref(idx, bounds, offset, stream, states, esc_pos, esc_val)
    return _decode("eb_decode", False, idx, bounds, offset, stream, states,
                   esc_pos, esc_val)


@functools.lru_cache(maxsize=None)
def _gmm_tables(device: torch.device):
    return gmm_phi_table().to(device), gmm_exp_table().to(device)


def gmm_rows(params: torch.Tensor, K: int, padded: int, widest: torch.Tensor | None = None):
    """K6: (B, P, 3 K M) float32 parameters of one parity's packed pixels
    (K blocks of M logits, then of means, then of scales) -> (heads (B,
    padded) int32, rows (B, padded, GMM_SEGMENTS) int16 holding u16 bits)
    for the P * M elements in (pixel, channel) order, the pad row past
    them. Equal bits on every device for equal float inputs. ``widest``,
    a (1,) int32 tensor on the same device, takes the max of its value and
    the rows' widest coded support (nseg << k symbols)."""
    if params.device.type == "cpu":
        heads, rows = gmm_rows_ref(params, K, padded)
        if widest is not None and heads.numel():
            _, k, nseg = gmm_unpack_head(heads.long())
            widest.copy_(torch.maximum(widest, (nseg << k).max().to(widest.dtype)))
        return heads, rows
    device = params.device
    _check("gmm_rows", device, params=(params, torch.float32, 3))
    if widest is not None:
        _check("gmm_rows", device, widest=(widest, torch.int32, 1))
    B, P, C = params.shape
    if not 0 < K <= 4 or C % (3 * K) or padded < P * (C // (3 * K)):
        raise ValueError(f"gmm_rows: {tuple(params.shape)} parameters of {K} components "
                         f"do not fit {padded} elements")
    if B * padded >= 1 << 30:
        raise ValueError(f"gmm_rows: too many elements ({B} x {padded})")
    heads = torch.empty((B, padded), dtype=torch.int32, device=device)
    rows = torch.empty((B, padded, GMM_SEGMENTS), dtype=torch.int16, device=device)
    phi, ex = _gmm_tables(device)
    with torch.cuda.device(device):
        cs = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().hyk_gmm_rows(params.data_ptr(), K, C // (3 * K), P, padded, B,
                                 phi.data_ptr(), ex.data_ptr(), heads.data_ptr(),
                                 rows.data_ptr(),
                                 None if widest is None else widest.data_ptr(), cs)
    _raise_on("gmm_rows", rc)
    LAUNCHES["gmm_rows"] += 1
    return heads, rows


def gmm_decode(heads, rows, stream, states, esc_pos, esc_val):
    """Forward decode of Gaussian-mixture planes: heads (B, T, lanes) int32
    and rows (B, T, lanes, GMM_SEGMENTS) int16 from ``gmm_rows``; stream,
    states and escape lists as ``gauss_decode`` -> (B, T * lanes) int32
    symbols. The rows stream from global memory, a few steps ahead."""
    if heads.device.type == "cpu":
        return gmm_decode_ref(heads, rows, stream, states, esc_pos, esc_val)
    device = heads.device
    B, T, lanes = heads.shape
    _check("gmm_decode", device, heads=(heads, torch.int32, 3),
           rows=(rows, torch.int16, 4), stream=(stream, torch.int16, 2),
           states=(states, torch.int32, 2), esc_pos=(esc_pos, torch.int32, 2),
           esc_val=(esc_val, torch.int32, 2))
    _check_lanes("gmm_decode", lanes)
    if (rows.shape != (B, T, lanes, GMM_SEGMENTS) or stream.shape[0] != B
            or stream.shape[1] < 1 or states.shape != (B, lanes)
            or esc_pos.shape != (B, ESC_MAX) or esc_val.shape != (B, ESC_MAX)):
        raise ValueError("gmm_decode: inconsistent shapes")
    if B * T * lanes >= 1 << 30:
        raise ValueError(f"gmm_decode: plane too large ({B}, {T}, {lanes})")
    # the kernel copies a thread's heads and rows 16 bytes at a time
    heads, rows = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (heads, rows))
    out = torch.empty((B, T * lanes), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        cs = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().hyk_gmm_decode(heads.data_ptr(), rows.data_ptr(), stream.data_ptr(),
                                   stream.shape[1], states.data_ptr(), esc_pos.data_ptr(),
                                   esc_val.data_ptr(), out.data_ptr(), B, T, lanes, cs)
    _raise_on("gmm_decode", rc)
    LAUNCHES["gmm_decode"] += 1
    LAUNCH_SHAPES["gmm_decode", lanes] += 1
    return out
