#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hyres_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:

1. device  -- the card's name and power limit (nvidia-smi), device count.
2. build   -- nvcc build of the CUDA kernels and g++ build of the host
              coding library, from the sources in this checkout.
3. kernels -- K1 (fdct_quant_planes) and K2 (dequant_idct_planes) on the
              main path's three planes of a 768x512 image (6144 luma
              blocks, 1536 per chroma plane; one launch each), held
              against their plain PyTorch versions (K2 on int32, int8 and
              int16 coefficients) and timed beside their bounds; then the
              JPEG encode and decode under sync-debug "error", which must
              raise nothing.
4. coder   -- K3 (encode_planes), K4 (gauss_decode) and K5 (eb_decode) on
              the symbols of a real request (the original image through
              the float32 stages): K3 encodes z and both y halves in one
              launch and must give the plain version's streams, states and
              word counts, so byte-identical frames; K4 (anchor and
              non-anchor) and K5 decode those frames to the plain
              version's symbols, which equal the coded ones. Timed over
              20 back-to-back calls, with us a serial step and the serial
              floor. Then a seeded high-rate gaussian plane and a
              seeded high-rate factorized plane, whose streams are longer
              than the decoders' shared-memory ring, go through K3 and K4
              or K5, held against the plain versions on CPU copies.
5. main    -- the HyRES deployment roundtrip (``HyresCodec.compress`` then
              ``decompress``) on the trained artifact at full width (N=128,
              M=192, JPEG quality 1), serving three requests (an in-repo
              768x512 image, its horizontal and its vertical flip) in
              bfloat16 and in float32, first with the host rANS coder, then
              with the device coder (K3-K5). Each path runs with the launch
              counts set to 0 just before it and read just after: K1
              exactly once a roundtrip and K2 exactly twice on both, K3-K5
              on the second, which must also re-frame nothing with the
              host coder. Then one compress and decompress a precision
              under sync-debug "warn" print their synchronising calls.
              Every decoded symbol must equal the coded one, and the
              float32 bpp/PSNR of the original image must lie within 1% /
              0.05 dB of the JAX reference's numbers for the same coder.
6. serve   -- the serving entry points on the device coder, bf16 and f32:
              one ``_compress_dispatch`` and one ``_dec_dispatch_from_comp``
              under sync-debug "error" (which must raise nothing), then the
              synchronising calls of a full request; ``inference_stream``
              at depth 2 and 3 over 9 requests (the three images, three
              times) equal to sequential ``inference`` (strings and JFIF
              bytes identical, ``x_hat`` ``torch.equal``), with the launch
              counts set to 0 just before a stream and read just after (n
              K1, 2n K2, n K3, 2n K4, n K5); sequential against stream
              walls a request for both coders (printed, not gated) and
              the device's idle share in a traced stream; then the CLIs in
              process: ``cli.codec`` encode/decode of the three images, each
              PNG byte-equal to ``save_image`` of the in-process decode, and
              ``cli.inference --stream 2`` giving the sequential run's
              ``total_bpp`` and ``psnr``.
7. train   -- the training path at the recipe (N=128, M=192, JPEG quality
              1, batch 16 of 256x256 crops of the image and its flips):
              (a) 3 warm-up and 10 timed steps from the artifact's weights in
              f32 and in bf16 (ms a step, peak memory, each step's metrics,
              K1/K2 launches exactly 1 and 1 a step, a traced step's idle
              share and top operations), then one step with accumulation 2
              (2 and 2 launches); K1/K2 on the step's batch against their
              plain versions (coefficients and scan bits equal, K2 within
              1e-4) with the JPEG layer's device time; (b) the first step's
              loss and gradients at batch 2 on the card against the CPU with
              the plain K1/K2 and the same noise (loss rel 1e-4, each
              gradient leaf 1e-3 of its max |g|); (c) 20 steps from the
              port's own initialisation, finite, none skipped, the last 5
              below the first 5; (d) ``cli.training`` in process: 2 epochs
              of 3 steps from --pretrained on the artifact, 1 resumed epoch,
              ``cli.updata``, and a device-coder roundtrip of the baked
              artifact (symbols exact); (e) the process-wide cuDNN/TF32
              flags unchanged and the f32 device-coder roundtrip of the
              original image still at bpp 1.6257731119791667 and PSNR
              33.63140531071406 dB, bit for bit.
8. profile -- one traced compress and decompress per coder and precision.

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' launches and times, and ``{"ok": true, "device": ...}``. The
full measurements go to ``smoke_out/chip_smoke.json``. Any
failure exits non-zero. Without CUDA, or without the package beside this
script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"

# f32 quality of the JAX reference (same artifact and image) with its host
# coder and with its device coder ("tpu"; the port's "device"), computed on
# the CPU by
#   JAX_PLATFORMS=cpu python scripts/torch_port_anchor.py --coder {host,tpu}
JAX_ANCHOR = {"host": {"bpp": 1.6045125325520833, "psnr": 33.631405273186445},
              "device": {"bpp": 1.6257731119791667, "psnr": 33.631405273186445}}
BPP_RTOL = 0.01
PSNR_ATOL_DB = 0.05
CODERS = ("host", "device")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores. The kernels compute in plain FP32.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# K1 bar (tests/test_kernels.py:27-31): at most 0.1% of coefficients off
# by one, none by more. K2 bar: atol 1e-2. K3-K5: exact (integer coder).
K1_MISMATCH_FRAC = 0.001
K2_ATOL = 1e-2

# The coder kernels' operations bound: 32-bit integer instructions a
# symbol, counted from csrc/rans.cu (K3: two pushes with one u32 / u16
# division; K4: a rank search, two renorm rounds, the low-bit pop; K5: a
# rank search and one renorm round), at the FP32 rate outside the
# tensor cores. Their bytes bound is larger at the main path's shapes.
OPS_PER_SYMBOL = {"K3": 40, "K4": 50, "K5": 34}

# Serial floor of the coder kernels: T times the shortest dependent chain
# of one step, in SM cycles at the card's maximum SM clock. Assumed
# latencies (Hopper, no contention): shared-memory load 30, ballot + popc
# 10, integer or float op 4.
CHAIN_CYCLES = {
    # low push (3 ops), the reciprocal-estimate division (6 ops), 3 ops:
    # the ranks are off the state chain
    "K3": 3 * 4 + 6 * 4 + 3 * 4,
    # LUT load, bound loads, one search probe, state update; per renorm
    # round a ballot and a shared-memory stream read; the low pop between
    "K4": 30 + 30 + 30 + 2 * 4 + 2 * (10 + 30) + 3 * 4,
    # K4's chain with one renorm round and no low pop (the main path's
    # table takes K5's LUT layout)
    "K5": 30 + 30 + 30 + 2 * 4 + (10 + 30),
}
# K4/K5's stream ring in shared memory (csrc/rans.cu kChunks x kChunkWords)
RING_WORDS = 8 * 2048

T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {phase}: {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def phase_device(torch) -> tuple[str, str, float]:
    smi = _smi("name,power.limit")
    sm_mhz = float(_smi("clocks.max.sm", "csv,noheader,nounits"))
    kind = torch.cuda.get_device_name(0)
    log("device", f"{smi}, max SM clock {sm_mhz:.0f} MHz | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    return smi, kind, sm_mhz


def phase_build() -> None:
    from hyres_tpu_torch.kernels import build

    for name, (path, secs) in build.build_all().items():
        log("build", f"{name}: {secs:.2f} s -> {path.name}")
        report = Path(str(path) + ".log")
        if name != "hyres_coding" and report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("build", "  ptxas " + line.strip())


def _event_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median of ``reps`` single-call timings with CUDA events: what one
    call costs on the stream, host launch overhead included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _dev_us(e, attr: str = "device_time_total") -> float:
    """Device time of a profiler event or average, in us (newer torch names
    it ``*device_time*``, older ``*cuda_time*``)."""
    v = getattr(e, attr, None)
    if v is None:
        v = getattr(e, attr.replace("device", "cuda"), 0.0)
    return float(v)


def _profile(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return prof, out


def _device_ms(torch, fn, reps: int = 50, warmup: int = 5) -> tuple[float, str]:
    """Device time per call: the summed duration of the device work ``fn``
    launches, traced by torch.profiler over ``reps`` calls. Where the
    trace holds no device work, the CUDA-event time (host overhead
    included) stands in, and the returned source says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    prof, _ = _profile(torch, lambda: [fn() for _ in range(reps)])
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not evs:
        return _event_ms(torch, fn), "cuda-events"
    return sum(_dev_us(e) for e in evs) / reps / 1e3, "profiler"


def _stream_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """ms a call over ``reps`` back-to-back calls between two CUDA events.
    For the coder kernels (0.5-5 ms a call, far more than a call's host
    work) the stream never idles, so this is device time; it agrees with a
    profiler trace of as many calls, which short traces need not do."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _bound(n: int, in_bytes: int, out_bytes: int) -> tuple[float, str]:
    """Least time for one call on n blocks: inputs read once (blocks, the
    64x64 matrix, the two distinct quant tables), output written once, 64
    FMAs per coefficient in FP32."""
    nbytes = n * 64 * (in_bytes + out_bytes) + 64 * 64 * 4 + 2 * 64 * 4
    flops = 2.0 * n * 64 * 64
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _syncs(torch, fn) -> tuple[list, object]:
    """The synchronising CUDA operations ``fn`` makes, caught with
    ``torch.cuda.set_sync_debug_mode("warn")``: for each, the file and
    line of the Python call that made it."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)], out


def phase_kernels(torch, x) -> dict:
    """K1 and K2 against their plain versions on the main path's three
    planes of one request, one fused launch each; the JPEG path alone
    under sync-debug "error"."""
    import numpy as np

    from hyres_tpu_torch.jpeg import core, tables
    from hyres_tpu_torch.kernels import dct

    qy, qc = tables.quality_to_qtables(1)
    qts = [qy, qc, qc]
    y, cb, cr = core.rgb_to_ycbcr(x)
    planes = [y, core.downsample_420(cb), core.downsample_420(cr)]
    n = sum(p.numel() for p in planes) // 64
    got1 = dct.fdct_quant_planes(planes, qts)
    want1 = dct.fdct_quant_planes_ref(planes, qts)
    diff1 = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(got1, want1)])
    mism = int((diff1 != 0).sum())
    err1 = int(diff1.max())
    check(err1 <= 1 and mism <= K1_MISMATCH_FRAC * diff1.numel(),
          f"K1: {mism} coefficients differ, max {err1}")
    # K2 on the path's own coefficients as compress (int32) and decompress
    # (int8) give them, and on a fine quantizer's in int16 (the quality-1
    # coefficients are mostly zero)
    c8 = [c.to(torch.int8) for c in got1]
    fine = [np.full(64, 4.0, np.float32)] * 3
    c16 = [c.to(torch.int16) for c in dct.fdct_quant_planes_ref(planes, fine)]
    err2 = {}
    for label, coefs, qq in (("int32", got1, qts), ("int8", c8, qts), ("int16", c16, fine)):
        got2 = dct.dequant_idct_planes(coefs, qq)
        want2 = dct.dequant_idct_planes_ref(coefs, qq)
        err2[label] = max(float((g - w).abs().max()) for g, w in zip(got2, want2))
        check(err2[label] <= K2_ATOL, f"K2 {label}: max abs err {err2[label]}")
    torch.cuda.synchronize()

    # the JPEG path alone makes no synchronising call (the K1/K2 matrices
    # are uploaded once a process, above)
    torch.cuda.set_sync_debug_mode("error")
    try:
        coef = core.encode_to_coefficients(x, 1)
        core.decode_with_qtables(*c8, qy, qc, x.shape[1], x.shape[2])
        core.decode_from_coefficients(coef.y, coef.cb, coef.cr, 1, x.shape[1], x.shape[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("kernels", "JPEG encode + both decodes under sync-debug \"error\": no sync")

    blocks = torch.cat([dct.blockify(p).reshape(-1, 64) for p in planes])
    m_fwd = torch.from_numpy(dct.KRON.T.copy()).cuda()
    calls = {
        "K1": (lambda: dct.fdct_quant_planes(planes, qts),
               lambda: dct.fdct_quant_planes_ref(planes, qts), _bound(n, 4, 4)),
        "K2": (lambda: dct.dequant_idct_planes(c8, qts),
               lambda: dct.dequant_idct_planes_ref(c8, qts), _bound(n, 1, 4)),
        "K2 int32": (lambda: dct.dequant_idct_planes(got1, qts),
                     lambda: dct.dequant_idct_planes_ref(got1, qts), _bound(n, 4, 4)),
    }
    stats = {"n": n, "mismatches": mism, "matmul_ms": _device_ms(
        torch, lambda: torch.matmul(blocks, m_fwd))[0]}
    for k, (kern, plain, (bound_ms, bound_by)) in calls.items():
        k_ms, src = _device_ms(torch, kern)
        p_ms, _ = _device_ms(torch, plain)
        err = err1 if k == "K1" else err2["int8" if k == "K2" else "int32"]
        stats[k] = {"ms": k_ms, "plain_ms": p_ms, "source": src, "max_abs_err": err,
                    "call_ms": _event_ms(torch, kern), "plain_call_ms": _event_ms(torch, plain),
                    "bound_ms": bound_ms, "bound_by": bound_by}
        t = stats[k]
        what = f"{mism} off by one" if k == "K1" else f"max abs err {err:.3g}"
        log("kernels", f"{k} ({'fdct_quant_planes' if k == 'K1' else 'dequant_idct_planes'}) "
            f"on 3 planes, N={n}: {what}; device ms kernel {k_ms:.5f} plain {p_ms:.5f} "
            f"({src}); per call on the stream kernel {t['call_ms']:.5f} plain "
            f"{t['plain_call_ms']:.5f}; bound {bound_ms * 1e3:.3f} us ({bound_by}), "
            f"{bound_ms / k_ms:.2f} of it")
    log("kernels", f"K2 int16 (fine quantizer): max abs err {err2['int16']:.3g}; matmul "
        f"(N,64)@(64,64) yardstick N={n}: device ms {stats['matmul_ms']:.5f}")
    return stats


def _np(a):
    """numpy view of symbols from either coder (numpy, or a device tensor)."""
    import numpy as np

    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _timed_once(torch, fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def _bound_ms(nbytes: float, n_sym: int, ops_per_sym: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = n_sym * ops_per_sym / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_coder(torch, codec, x, sm_mhz: float) -> dict:
    """K3-K5 against their plain versions on the symbols of one request,
    then K3 and K4 on a high-rate plane."""
    import numpy as np

    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models.codec import DevicePlaneCoder

    r = codec._residual
    dc = r.device_coder
    with torch.inference_mode():
        _, y, z_sym = codec.enc_front(x)
        lp, a_idx, ma_p, a_sym = r.dec_stage1(z_sym, y)
        _, n_idx, _, n_sym = r.dec_stage2(lp, a_sym, ma_p, y)
    jobs = dc.jobs(z_sym, a_sym, a_idx, n_sym, n_idx)
    planes = [j.plane for j in jobs]
    labels = ("z", "anchor", "non-anchor")
    out = {}

    # K3: one launch for the three planes against the plain version
    got = krans.encode_planes(planes)
    torch.cuda.synchronize()
    want = krans.encode_planes_ref(planes)
    err3 = 0
    frames = []
    for label, j, g, w in zip(labels, jobs, got, want):
        for a, b in zip(g, w):
            err3 = max(err3, int((a.long() - b.long()).abs().max()))
        esc = dr.escape_lists(j.sym, j.esc)
        encs = [{k: v.cpu().numpy() for k, v in zip(
            ("stream", "states", "n_renorm", "esc_pos", "esc_val", "n_esc"),
            (*gw, *esc))} for gw in (g, w)]
        fg, fw = (DevicePlaneCoder.frames_from_enc(e) for e in encs)
        check(fg == fw, f"K3 {label}: frames differ from the plain version's")
        frames.append(fg)
        log("coder", f"K3 {label}: lanes {j.lanes}, T {j.plane.start.shape[1]}, "
            f"{int(g[2][0])} renorm words of cap {j.plane.cap}, "
            f"{int(esc[2][0])} escapes, {len(fg[0])} bytes; frames identical")
    check(err3 == 0, f"K3: max abs err {err3}")
    k3_ms, k3_src = _stream_ms(torch, lambda: krans.encode_planes(planes)), "cuda-events"
    p3_ms, _ = _timed_once(torch, lambda: krans.encode_planes_ref(planes))
    n3 = sum(p.start.numel() for p in planes)
    nbytes3 = (sum(4 * 4 * p.start.numel() for p in planes)
               + sum(2 * int(g[2].sum()) + 4 * g[1].numel() + 4 * g[2].numel()
                     for g in got))
    b3 = _bound_ms(nbytes3, n3, OPS_PER_SYMBOL["K3"])
    T3 = max(p.start.shape[1] for p in planes)
    out["K3"] = {"ms": k3_ms, "source": k3_src, "plain_ms": p3_ms,
                 "max_abs_err": err3, "bound_ms": b3[0], "bound_by": b3[1],
                 "T": T3, "ms_per_step": k3_ms / T3, "symbols": n3,
                 "serial_floor_ms": T3 * CHAIN_CYCLES["K3"] / (sm_mhz * 1e3)}

    # K4 (both y halves) and K5 (z) on those frames
    n_z, n_y = z_sym[0].numel(), a_sym[0].numel()
    cases = (("K5", "z", krans.eb_decode, krans.eb_decode_ref, frames[0], n_z,
              dc._z_idx(z_sym.shape, x.device), dc.eb.bounds, dc.eb.offset, z_sym),
             ("K4", "anchor", krans.gauss_decode, krans.gauss_decode_ref, frames[1],
              n_y, a_idx, dc.gauss.bounds, dc.gauss.params, a_sym),
             ("K4", "non-anchor", krans.gauss_decode, krans.gauss_decode_ref,
              frames[2], n_y, n_idx, dc.gauss.bounds, dc.gauss.params, n_sym))
    for k, label, kern, plain, fr, n, idx, bounds, aux, coded in cases:
        lanes, states, stream, ep, ev = DevicePlaneCoder.unframe_batch(fr, n)
        T = -(-n // lanes)
        args = (dr.to_tl(idx.reshape(1, -1), T, lanes, 0), bounds, aux,
                torch.from_numpy(stream.view(np.int16)).cuda(),
                torch.from_numpy(states.view(np.int32)).cuda(),
                torch.from_numpy(ep).cuda(), torch.from_numpy(ev).cuda())
        g = kern(*args)
        torch.cuda.synchronize()
        w = plain(*args)
        err = int((g.long() - w.long()).abs().max())
        check(err == 0, f"{k} {label}: max abs err {err} against the plain version")
        check(torch.equal(w[0, :n], coded.reshape(-1).to(torch.int32)),
              f"{k} {label}: decoded symbols differ from the coded ones")
        log("coder", f"{k} {label}: lanes {lanes}, T {T}: symbols exact")
        if k in out:  # one timing per kernel: K4 on the anchor half
            continue
        k_ms, src = _stream_ms(torch, lambda: kern(*args)), "cuda-events"
        p_ms, _ = _timed_once(torch, lambda: plain(*args))
        nbytes = (4 * args[0].numel() * 2 + 2 * len(stream[0]) + 4 * lanes
                  + 8 * dr.ESC_MAX + 4 * bounds.numel() + 4 * aux.numel())
        b = _bound_ms(nbytes, args[0].numel(), OPS_PER_SYMBOL[k])
        out[k] = {"ms": k_ms, "source": src, "plain_ms": p_ms, "max_abs_err": err,
                  "bound_ms": b[0], "bound_by": b[1], "T": T,
                  "ms_per_step": k_ms / T, "symbols": args[0].numel(),
                  "serial_floor_ms": T * CHAIN_CYCLES[k] / (sm_mhz * 1e3)}
    for k in ("K3", "K4", "K5"):
        t = out[k]
        log("coder", f"{k}: device ms {t['ms']:.4f} ({t['source']}), "
            f"{t['ms_per_step'] * 1e3:.4f} us a step over T={t['T']}; plain "
            f"{t['plain_ms']:.2f} ms (host clock, one call); bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}); serial floor "
            f"{t['serial_floor_ms']:.4f} ms ({CHAIN_CYCLES[k]} cycles a step at "
            f"{sm_mhz:.0f} MHz)")
    out["high_rate"] = _high_rate_plane(torch, codec)
    return out


def _high_rate_plane(torch, codec) -> dict:
    """Two seeded high-rate planes whose streams are longer than the
    decoders' shared-memory ring, so the ring refills: a gaussian plane at
    the widest scale row (about 0.6 words a symbol, 128 lanes) through K3
    and K4, and a factorized plane in each row's four rarest bins (a word
    a symbol, 64 lanes as the main path's z) through K3 and K5, each
    against its plain version on CPU copies of the same inputs."""
    import numpy as np

    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.entropy import get_scale_table
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models.codec import DevicePlaneCoder

    dc = codec._residual.device_coder
    gt, et = dc.gauss, dc.eb
    rng = np.random.default_rng(2026)
    sym_g = np.round(rng.normal(0.0, get_scale_table()[63], (1, 65000))).astype(np.int32)
    idx_g = np.full(sym_g.shape, 63, np.int32)
    rows = et.offset.shape[0]
    idx_e = np.broadcast_to(np.arange(40000) % rows, (1, 40000)).astype(np.int32)
    maxv, freq = et.maxv.cpu().numpy(), et.freq.cpu().numpy()
    rare = np.stack([np.argsort(freq[r, :maxv[r]], kind="stable")[:4] for r in range(rows)])
    sym_e = (et.offset.cpu().numpy()[idx_e]
             + rare[idx_e, rng.integers(0, 4, idx_e.shape)]).astype(np.int32)
    cases = (("K4", sym_g, idx_g, 128, dr.gauss_plane, gt, (gt.bounds, gt.params),
              krans.gauss_decode, krans.gauss_decode_ref),
             ("K5", sym_e, idx_e, 64, dr.eb_plane, et, (et.bounds, et.offset),
              krans.eb_decode, krans.eb_decode_ref))
    out = {}
    for k, sym, idx, lanes, plane, tab, (bounds, aux), kern, plain in cases:
        n = sym.shape[1]
        job = plane(torch.from_numpy(sym).cuda(), torch.from_numpy(idx).cuda(), tab, lanes)
        p = job.plane
        (g3,) = krans.encode_planes([p])
        torch.cuda.synchronize()
        (w3,) = krans.encode_planes_ref([p._replace(**{f: getattr(p, f).cpu() for f in
                                                       ("start", "freq", "low", "ks")})])
        err3 = max(int((a.cpu().long() - b.long()).abs().max()) for a, b in zip(g3, w3))
        words = int(w3[2][0])
        check(err3 == 0, f"K3 high-rate plane for {k}: max abs err {err3} against the plain "
              "version")
        check(words > RING_WORDS,
              f"high-rate plane for {k}: {words} words do not exceed the ring {RING_WORDS}")
        esc = dr.escape_lists(job.sym, job.esc)
        frames = DevicePlaneCoder.frames_from_enc({f: v.cpu().numpy() for f, v in zip(
            ("stream", "states", "n_renorm", "esc_pos", "esc_val", "n_esc"), (*g3, *esc))})
        lanes_f, states, stream, ep, ev = DevicePlaneCoder.unframe_batch(frames, n)
        T = -(-n // lanes_f)
        args = (dr.to_tl(torch.from_numpy(idx), T, lanes_f, 0), bounds.cpu(), aux.cpu(),
                torch.from_numpy(stream.view(np.int16)),
                torch.from_numpy(states.view(np.int32)),
                torch.from_numpy(ep), torch.from_numpy(ev))
        cuda_args = [a.cuda() for a in args]
        g = kern(*cuda_args)
        torch.cuda.synchronize()
        w = plain(*args)
        err = int((g.cpu().long() - w.long()).abs().max())
        check(err == 0, f"{k} high-rate plane: max abs err {err} against the plain version")
        check(torch.equal(w[0, :n], torch.from_numpy(sym[0])),
              f"{k} high-rate plane: decoded symbols differ from the coded ones")
        k3_ms = _stream_ms(torch, lambda: krans.encode_planes([p]))
        k_ms = _stream_ms(torch, lambda: kern(*cuda_args))
        log("coder", f"high-rate plane for {k}: lanes {lanes_f}, T {T}, {words} renorm words "
            f"({words / RING_WORDS:.2f} rings), S {stream.shape[1]}; K3 and {k} exact "
            f"against the plain versions; device ms K3 {k3_ms:.4f} ({k3_ms / T * 1e3:.4f} us "
            f"a step), {k} {k_ms:.4f} ({k_ms / T * 1e3:.4f} us a step)")
        out[k] = {"n": n, "lanes": lanes_f, "T": T, "words": words,
                  "S": int(stream.shape[1]), "K3_ms": k3_ms, f"{k}_ms": k_ms,
                  "K3_max_abs_err": err3, f"{k}_max_abs_err": err}
    return out


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / mse))


def _nbytes(comp) -> int:
    return (sum(len(b) for b in comp["jpeg_buffers"])
            + sum(len(s) for part in comp["strings"][0] for s in part)
            + sum(len(s) for s in comp["strings"][1]))


def _roundtrip(torch, codec, x):
    torch.cuda.synchronize()
    t = time.perf_counter()
    comp = codec.compress(x)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t
    t = time.perf_counter()
    dec = codec.decompress(comp)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t
    return comp, dec, t_c, t_d


def phase_main(torch, x, codecs) -> dict:
    """Three requests through compress/decompress, bf16 then f32, for each
    coder; each coder's path reads its own launch counts."""
    import numpy as np

    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec

    requests = {"original": x, "hflip": x.flip(2).contiguous(),
                "vflip": x.flip(1).contiguous()}
    log("main", f"{len(requests)} requests of {tuple(x.shape[1:3])} per "
        "coder and precision")
    for codec in codecs.values():
        for _ in range(2):  # warm-up roundtrips
            _roundtrip(torch, codec, x)
    log("main", "warm-up done (2 roundtrips per coder and precision)")

    h, w = x.shape[1], x.shape[2]
    out = {"launches": {}, "host_fallbacks": {}, "syncs": {}, "requests": []}
    for coder in CODERS:
        dct.reset_launches()
        krans.reset_launches()
        tcodec.reset_wire_stats()
        results = []
        for (c, name), codec in codecs.items():
            if c != coder:
                continue
            for req, xr in requests.items():
                comp, dec, t_c, t_d = _roundtrip(torch, codec, xr)
                results.append((name, req, xr, comp, dec, t_c, t_d))
        launches = {**dct.LAUNCHES, **krans.LAUNCHES}
        out["launches"][coder] = launches
        out["host_fallbacks"][coder] = tcodec.WIRE_STATS["host_fallbacks"]
        # K1 once a compress, K2 once a compress and once a decompress
        n_rt = len(results)
        check(launches["fdct_quant_blocks"] == n_rt
              and launches["dequant_idct_blocks"] == 2 * n_rt,
              f"{coder} coder: {n_rt} roundtrips launched K1 "
              f"{launches['fdct_quant_blocks']} and K2 {launches['dequant_idct_blocks']} "
              f"times, not {n_rt} and {2 * n_rt}")
        if coder == "device":
            for k in krans.LAUNCHES:
                check(launches[k] > 0, f"kernel {k} was not launched on the "
                      f"{coder}-coder path")
            check(tcodec.WIRE_STATS["host_fallbacks"] == 0,
                  f"device coder re-framed with the host coder: "
                  f"{tcodec.WIRE_STATS['fallback_reasons']}")
        log("main", f"{coder} coder: kernel launches on its path {launches} in {n_rt} "
            f"roundtrips, host fallbacks {tcodec.WIRE_STATS['host_fallbacks']}")
        for (c, name), codec in codecs.items():
            if c != coder:
                continue
            s_c, comp = _syncs(torch, lambda: codec.compress(x))
            s_d, _ = _syncs(torch, lambda: codec.decompress(comp))
            out["syncs"][f"{coder} {name}"] = {"compress": s_c, "decompress": s_d}
            log("main", f"{coder} {name}: synchronising calls a request (sync-debug "
                f"\"warn\"): compress {len(s_c)} {s_c}, decompress {len(s_d)} {s_d}")

        for name, req, xr, comp, dec, t_c, t_d in results:
            for a, b in zip(comp["symbols"], dec["symbols"]):
                a, b = _np(a), _np(b)
                check(a.shape == b.shape and np.array_equal(a, b),
                      f"{coder}/{name}/{req}: decoded symbols differ from the "
                      "coded ones")
            x_hat = dec["x_hat"].float().cpu().numpy()
            check(x_hat.shape == tuple(xr.shape) and np.isfinite(x_hat).all(),
                  f"{coder}/{name}/{req}: bad reconstruction {x_hat.shape}")
            ref = xr.cpu().numpy()
            bpp = _nbytes(comp) * 8.0 / (h * w)
            psnr = _psnr(x_hat, ref)
            jpeg_psnr = _psnr(codecs[(coder, name)].decode_jpeg(comp["jpeg_buffers"])
                              .cpu().numpy(), ref)
            check(psnr > jpeg_psnr, f"{coder}/{name}/{req}: PSNR {psnr:.4f} dB "
                  f"does not beat the JPEG base layer's {jpeg_psnr:.4f} dB")
            out["requests"].append({"coder": coder, "precision": name,
                                    "request": req, "compress_ms": t_c * 1e3,
                                    "decompress_ms": t_d * 1e3, "bpp": bpp,
                                    "psnr": psnr, "jpeg_psnr": jpeg_psnr})
            log("main", f"{coder} {name} {req}: compress {t_c * 1e3:.2f} ms, "
                f"decompress {t_d * 1e3:.2f} ms, bpp {bpp!r}, psnr {psnr!r} dB "
                f"(JPEG alone {jpeg_psnr!r} dB), symbols exact")
            if name == "f32" and req == "original":
                anchor = JAX_ANCHOR[coder]
                check(abs(bpp - anchor["bpp"]) <= BPP_RTOL * anchor["bpp"],
                      f"{coder} f32 bpp {bpp} vs JAX {anchor['bpp']}")
                check(abs(psnr - anchor["psnr"]) <= PSNR_ATOL_DB,
                      f"{coder} f32 psnr {psnr} vs JAX {anchor['psnr']}")
                log("main", f"{coder} f32 original vs JAX anchor: bpp {bpp!r} vs "
                    f"{anchor['bpp']!r}, psnr {psnr!r} vs {anchor['psnr']!r}")
    return out


SERVE_TURNS = 7
SERVE_REPEAT = 3  # the three images, three times: 9 requests a stream


def _same_outputs(torch, seq, outs, label: str) -> None:
    check(len(seq) == len(outs), f"{label}: {len(outs)} outputs for {len(seq)} requests")
    for i, (a, b) in enumerate(zip(seq, outs)):
        check(b["strings"] == a["compressed"]["strings"]
              and b["compressed"]["jpeg_buffers"] == a["compressed"]["jpeg_buffers"],
              f"{label}: request {i}: bytes differ from the sequential run's")
        check(torch.equal(b["x_hat"], a["x_hat"]),
              f"{label}: request {i}: x_hat differs from the sequential run's")


def _walls(torch, codec, xs) -> dict:
    """ms a request over ``xs``: sequential ``inference`` against
    ``inference_stream`` at depth 2 and 3, in turns (the order reversed
    every other turn, against drift); medians over turns."""
    runs = {"sequential": lambda: [codec.inference(x) for x in xs],
            "stream2": lambda: codec.inference_stream(xs, depth=2),
            "stream3": lambda: codec.inference_stream(xs, depth=3)}
    out = {k: [] for k in runs}
    for turn in range(SERVE_TURNS):
        for k in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            ms, _ = _timed_once(torch, runs[k])
            out[k].append(ms / len(xs))
    return {k: {"median_ms": sorted(v)[len(v) // 2], "turns_ms": v} for k, v in out.items()}


def _serve_clis(torch, x, codec) -> dict:
    """cli.codec and cli.inference in process on the three images."""
    import csv

    from hyres_tpu_torch.cli import codec as cli_codec
    from hyres_tpu_torch.cli import inference as cli_inference
    from hyres_tpu_torch.utils.png import save_image

    work = ROOT / "smoke_out" / "serve"
    images, hyc, pngs, want = (work / d for d in ("images", "hyc", "png", "want"))
    for d in (images, hyc, pngs, want):
        d.mkdir(parents=True, exist_ok=True)
    reqs = {"original": x, "hflip": x.flip(2), "vflip": x.flip(1)}
    for name, xr in reqs.items():
        save_image(xr, images / f"{name}.png")
    cli_codec.main(["encode", "--checkpoint", str(ARTIFACT), "--coder", "device",
                    str(images), "-o", str(hyc)])
    cli_codec.main(["decode", "--checkpoint", str(ARTIFACT), str(hyc), "-o", str(pngs)])
    for name, xr in reqs.items():
        dec = codec.decompress(codec.compress(xr.contiguous()))
        save_image(torch.clamp(dec["x_hat"], 0, 1), want / f"{name}.png")
        check((pngs / f"{name}.png").read_bytes() == (want / f"{name}.png").read_bytes(),
              f"cli.codec: {name}.png differs from save_image of the in-process decode")
    sizes = {name: (hyc / f"{name}.hyc").stat().st_size for name in reqs}
    rows = {}
    for mode, extra in (("sequential", []), ("stream2", ["--stream", "2"])):
        out = work / f"inference_{mode}"
        cli_inference.main(["--checkpoint", str(ARTIFACT), "--coder", "device",
                            "--input", str(images), "--output", str(out)] + extra)
        with open(out / "metrics.csv") as f:
            rows[mode] = {r["filename"]: r for r in csv.DictReader(f)}
    for name in reqs:
        a, b = rows["sequential"][f"{name}.png"], rows["stream2"][f"{name}.png"]
        check(a["total_bpp"] == b["total_bpp"] and a["psnr"] == b["psnr"],
              f"cli.inference --stream 2: {name} bpp/psnr {b['total_bpp']}/{b['psnr']} "
              f"against sequential {a['total_bpp']}/{a['psnr']}")
    return {"hyc_bytes": sizes, "metrics": rows}


def phase_serve(torch, x, codecs, smi: str) -> dict:
    """The serving entry points: dispatch halves without a sync, the stream
    equal to sequential runs with its launch counts, walls, and the CLIs."""
    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec
    from hyres_tpu_torch.utils.device import wait_event

    base = [x, x.flip(2).contiguous(), x.flip(1).contiguous()]
    xs = base * SERVE_REPEAT
    n = len(xs)
    out = {"syncs": {}, "launches": {}, "walls": {}, "idle": {}}
    for (coder, name), codec in codecs.items():
        if coder != "device":
            continue
        label = f"{coder} {name}"
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = codec._compress_dispatch(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        comp = codec._compress_finish(state)
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec = codec._dec_dispatch_from_comp(comp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wait_event(dec[3])
        pulls = tcodec.WIRE_STATS["d2h_syncs"]
        s_c, comp = _syncs(torch, lambda: codec.compress(x))
        pulls = tcodec.WIRE_STATS["d2h_syncs"] - pulls
        s_d, _ = _syncs(torch, lambda: codec.decompress(comp))
        out["syncs"][label] = {"compress": s_c, "decompress": s_d, "compress_event_waits": pulls}
        log("serve", f"{label}: _compress_dispatch and _dec_dispatch_from_comp under "
            f"sync-debug \"error\": no sync; a full request (sync-debug \"warn\"): "
            f"compress {len(s_c)} {s_c}, decompress {len(s_d)} {s_d}; event waits "
            f"(not flagged by sync-debug): compress {pulls} (the pull), decompress 1 "
            "(after the tail)")

        seq = [codec.inference(xr) for xr in xs]
        for depth in (2, 3):
            dct.reset_launches()
            krans.reset_launches()
            outs = codec.inference_stream(xs, depth=depth)
            launches = {**dct.LAUNCHES, **krans.LAUNCHES}
            torch.cuda.synchronize()
            _same_outputs(torch, seq, outs, f"{label} stream depth {depth}")
            want = {"fdct_quant_blocks": n, "dequant_idct_blocks": 2 * n,
                    "encode_planes": n, "gauss_decode": 2 * n, "eb_decode": n}
            check(launches == want, f"{label} stream depth {depth}: launches {launches}, "
                  f"not {want}")
            out["launches"][f"{label} depth {depth}"] = launches
        log("serve", f"{label}: inference_stream depth 2 and 3 over {n} requests equal "
            f"to sequential inference (bytes, x_hat); launches {launches}")

        torch.cuda.synchronize()
        t = time.perf_counter()
        prof, _ = _profile(torch, lambda: codec.inference_stream(xs, depth=2))
        traced = (time.perf_counter() - t) * 1e3
        busy = sum(_dev_us(e) for e in prof.events() if e.device_type.name == "CUDA") / 1e3
        wall, _ = _timed_once(torch, lambda: codec.inference_stream(xs, depth=2))
        out["idle"][label] = {"stream2_traced_wall_ms": traced, "stream2_wall_ms": wall,
                              "device_busy_ms": busy}
        log("serve", f"{label}: stream depth 2 of {n}: device busy {busy:.2f} ms; traced "
            f"wall {traced:.2f} ms (idle share {1 - busy / traced:.2f}), untraced wall "
            f"{wall:.2f} ms ({1 - busy / wall:.2f} of it idle)")

    for (coder, name), codec in codecs.items():
        w = _walls(torch, codec, xs)
        out["walls"][f"{coder} {name}"] = w
        log("serve", f"{coder} {name}: ms a request over {n} (median of {SERVE_TURNS} "
            f"turns): sequential {w['sequential']['median_ms']:.2f}, stream depth 2 "
            f"{w['stream2']['median_ms']:.2f}, depth 3 {w['stream3']['median_ms']:.2f} "
            f"({smi}); turns {({k: [round(t, 2) for t in v['turns_ms']] for k, v in w.items()})}")

    out["cli"] = _serve_clis(torch, x, codecs[("device", "f32")])
    log("serve", f"cli.codec: 3 images -> .hyc {out['cli']['hyc_bytes']} bytes -> PNGs "
        "equal to save_image of the in-process decode; cli.inference --stream 2 rows "
        "equal to sequential (total_bpp, psnr)")
    return out


# -- train ---------------------------------------------------------------------

TRAIN_B, TRAIN_P = 16, 256       # the recipe's batch and patch
TRAIN_LMBDA = 0.015              # cli/training.py's default
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_FRESH_STEPS = 20
STEP_LOSS_RTOL = 1e-4            # card step against the CPU step (float32)
STEP_GRAD_BAR = 1e-3             # of each gradient leaf's max |g|
K2_STEP_ATOL = 1e-4
# the f32 device-coder roundtrip of the original image, bit for bit
SERVE_F32 = {"bpp": 1.6257731119791667, "psnr": 33.63140531071406}


def _crops(np, rng, images, n: int):
    """n random TRAIN_P crops, each of a random one of ``images``."""
    out = []
    for _ in range(n):
        img = images[int(rng.integers(len(images)))]
        y0 = int(rng.integers(0, img.shape[0] - TRAIN_P + 1))
        x0 = int(rng.integers(0, img.shape[1] - TRAIN_P + 1))
        out.append(img[y0:y0 + TRAIN_P, x0:x0 + TRAIN_P])
    return np.stack(out).astype(np.float32)


def _recipe_model(torch, params, dtype, device):
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.utils.convert import load_state_dict

    model = ResidualJPEGCompression(128, 192, 1, compute_dtype=dtype)
    load_state_dict(model, params)
    return model.to(device)


def _train_state(torch, model):
    from hyres_tpu_torch.train import configure_optimizers, create_train_state

    main, aux = configure_optimizers(model, 1e-4, 1e-3, 1.0)
    return create_train_state(model, main, aux)


def _cudnn_flags(torch) -> dict:
    return {"deterministic": torch.backends.cudnn.deterministic,
            "benchmark": torch.backends.cudnn.benchmark,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_tf32": torch.backends.cuda.matmul.allow_tf32}


def _train_recipe(torch, params, batches, smi: str, dev: str) -> dict:
    """(a) Steps at the recipe in f32 and bf16: times, memory, metrics,
    K1/K2 launches a micro-step, one traced step; then one step with
    accumulation 2."""
    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.train import make_train_step

    out = {}
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        state = _train_state(torch, _recipe_model(torch, params, dt, dev))
        step = make_train_step(state, TRAIN_LMBDA)
        gen = torch.Generator(dev).manual_seed(0)
        xs = [torch.from_numpy(b).to(dev) for b in batches]
        for i in range(TRAIN_WARMUP):
            step(xs[i % len(xs)], gen, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dct.reset_launches()
        times, mets = [], []
        for i in range(TRAIN_TIMED):
            ms, m = _timed_once(torch, lambda: step(xs[i % len(xs)], gen, True))
            times.append(ms)
            mets.append({k: float(m[k]) for k in ("loss", "bpp_loss", "mse_loss",
                                                 "aux_loss", "skipped_nonfinite")})
        launches = dict(dct.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(launches == {"fdct_quant_blocks": TRAIN_TIMED,
                           "dequant_idct_blocks": TRAIN_TIMED},
              f"train {name}: {TRAIN_TIMED} steps launched K1/K2 {launches} times")
        check(all(m["skipped_nonfinite"] == 0 and math.isfinite(m["loss"]) for m in mets),
              f"train {name}: a step was skipped or not finite: {mets}")
        srt = sorted(times)
        log("train", f"{name} step at B={TRAIN_B}, {TRAIN_P}x{TRAIN_P}: median "
            f"{srt[len(srt) // 2]:.2f} ms, range {srt[0]:.2f}-{srt[-1]:.2f} ms over "
            f"{TRAIN_TIMED} steps ({smi}); peak memory {peak / 2**30:.2f} GiB; K1/K2 "
            f"launches {launches} (1 and 1 a micro-step)")
        for i, m in enumerate(mets):
            log("train", f"{name} step {i}: loss {m['loss']:.4f} bpp {m['bpp_loss']:.4f} "
                f"mse {m['mse_loss']:.3f} aux {m['aux_loss']:.2f}")
        # one traced step: idle share and the top device operations
        torch.cuda.synchronize()
        t = time.perf_counter()
        prof, _ = _profile(torch, lambda: step(xs[0], gen, True))
        traced = (time.perf_counter() - t) * 1e3
        busy = sum(_dev_us(e) for e in prof.events() if e.device_type.name == "CUDA") / 1e3
        by_op = sorted(((_dev_us(a, "self_device_time_total"), a.key)
                        for a in prof.key_averages() if a.key.startswith("aten::")),
                       reverse=True)[:6]
        mine = sorted(((_dev_us(a, "self_device_time_total"), a.key)
                       for a in prof.key_averages() if "dct_kernel" in a.key),
                      reverse=True)
        log("train", f"{name} traced step: wall {traced:.2f} ms, device busy {busy:.2f} ms, "
            f"idle share {1 - busy / traced:.3f}; top: "
            + ", ".join(f"{k} {us / 1e3:.2f} ms" for us, k in by_op)
            + "; hand-written: " + ", ".join(f"{k} {us / 1e3:.4f} ms" for us, k in mine))
        # accumulation 2: two micro-batches of B/2, K1/K2 once each
        acc = make_train_step(state, TRAIN_LMBDA, accum_steps=2)
        dct.reset_launches()
        m = acc(xs[0], gen, True)
        torch.cuda.synchronize()
        acc_launches = dict(dct.LAUNCHES)
        check(acc_launches == {"fdct_quant_blocks": 2, "dequant_idct_blocks": 2},
              f"train {name}: an accumulation-2 step launched K1/K2 {acc_launches} times")
        log("train", f"{name} accumulation-2 step: loss {float(m['loss']):.4f}, K1/K2 "
            f"launches {acc_launches}")
        out[name] = {"step_ms": times, "median_ms": srt[len(srt) // 2], "peak_bytes": peak,
                     "metrics": mets, "launches": launches, "acc_launches": acc_launches,
                     "traced_wall_ms": traced, "device_busy_ms": busy,
                     "top_ops": [[k, us / 1e3] for us, k in by_op],
                     "kernels": [[k, us / 1e3] for us, k in mine]}
        del state, step, acc, xs
        torch.cuda.empty_cache()
    return out


def _jpeg_pieces(torch, batch, dev: str) -> dict:
    """K1/K2 on the step's batch against their plain versions (coefficients
    and exact scan bits equal, K2 within K2_STEP_ATOL), and the device time
    of the training JPEG layer's parts."""
    from hyres_tpu_torch.jpeg import core, tables
    from hyres_tpu_torch.kernels import dct

    x = torch.from_numpy(batch).to(dev)
    qy, qc = tables.quality_to_qtables(1)
    y, cb, cr = core.rgb_to_ycbcr(x)
    planes = [y, core.downsample_420(cb), core.downsample_420(cr)]
    qts = [qy, qc, qc]
    got = dct.fdct_quant_planes(planes, qts)
    want = dct.fdct_quant_planes_ref(planes, qts)
    torch.cuda.synchronize()
    mism = sum(int((g != w).sum()) for g, w in zip(got, want))
    check(mism == 0, f"K1 on the step's batch: {mism} coefficients differ from the plain "
          "version's")
    bits = [core.scan_bits(core.JpegCoefficients(*c, TRAIN_P, TRAIN_P)) for c in (got, want)]
    check(torch.equal(bits[0], bits[1]), "scan bits of K1's coefficients differ from the "
          "plain version's")
    dec = dct.dequant_idct_planes(got, qts)
    dec_ref = dct.dequant_idct_planes_ref(got, qts)
    err2 = max(float((a - b).abs().max()) for a, b in zip(dec, dec_ref))
    check(err2 <= K2_STEP_ATOL, f"K2 on the step's batch: max abs err {err2}")
    n = sum(p.numel() for p in planes) // 64
    coef = core.JpegCoefficients(*got, TRAIN_P, TRAIN_P)
    parts = {"K1": lambda: dct.fdct_quant_planes(planes, qts),
             "K1 plain": lambda: dct.fdct_quant_planes_ref(planes, qts),
             "K2": lambda: dct.dequant_idct_planes(got, qts),
             "K2 plain": lambda: dct.dequant_idct_planes_ref(got, qts),
             "scan_bits": lambda: core.scan_bits(coef),
             "jpeg_roundtrip": lambda: core.jpeg_roundtrip(x, 1)}
    ms = {k: _device_ms(torch, fn, reps=20)[0] for k, fn in parts.items()}
    bound_ms, bound_by = _bound(n, 4, 4)  # both kernels read and write 4 bytes a value
    log("train", f"K1/K2 on the step's batch ({TRAIN_B}x{TRAIN_P}x{TRAIN_P}, {n} blocks): "
        f"coefficients and scan bits equal to the plain version's, K2 max abs err "
        f"{err2:.3g}; device ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f"; bound of K1 and of K2 {bound_ms:.5f} ms ({bound_by})")
    return {"blocks": n, "k2_max_abs_err": err2, "device_ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "scan_bits": bits[0].tolist()}


def _card_vs_cpu(torch, params, batch, dev: str) -> dict:
    """(b) The first step's loss and gradients at batch 2, on the card and
    with the plain versions on the CPU, with the same noise."""
    import numpy as np

    from hyres_tpu_torch.losses import rate_distortion_loss
    from hyres_tpu_torch.train.engine import train_numerics

    rng = np.random.default_rng(11)
    out = {}
    noise = None
    for d in (dev, "cpu"):
        model = _recipe_model(torch, params, None, d)
        if noise is None:
            y_shape, z_shape = model.residual_model.latent_shapes(batch.shape)
            shapes = {"z": model.residual_model.entropy_bottleneck.noise_shape(z_shape),
                      "y_anchor": y_shape, "y_nonanchor": y_shape}
            noise = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32) for k, s in shapes.items()}
        x = torch.from_numpy(batch).to(d)
        with train_numerics(torch.device(d)):
            o = model(x, noisequant=True,
                      noise={k: torch.from_numpy(v).to(d) for k, v in noise.items()})
            loss = rate_distortion_loss(o, x, TRAIN_LMBDA, 0.0)["loss"]
            loss.backward()
        out[d] = (float(loss), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                if p.grad is not None})
    (lc, gc), (lp, gp) = out[dev], out["cpu"]
    check(abs(lc - lp) <= STEP_LOSS_RTOL * abs(lp), f"card step loss {lc} vs CPU {lp}")
    check(gc.keys() == gp.keys(), "card and CPU steps give gradients to other leaves")
    worst = (0.0, "")
    for n in gp:
        scale = max(float(gp[n].abs().max()), 1e-30)
        rel = float((gc[n] - gp[n]).abs().max()) / scale
        worst = max(worst, (rel, n))
    check(worst[0] <= STEP_GRAD_BAR, f"gradient {worst[1]}: {worst[0]:.3g} of its max |g|")
    log("train", f"card step against the CPU step (batch 2, plain K1/K2 on the CPU, the "
        f"same noise): loss {lc!r} vs {lp!r} (rel {abs(lc - lp) / abs(lp):.2g}); "
        f"{len(gp)} gradient leaves, worst {worst[0]:.3g} of its max |g| ({worst[1]})")
    return {"loss_cuda": lc, "loss_cpu": lp, "worst_grad": list(worst)}


def _fresh(torch, images, rng, dev: str) -> dict:
    """(c) The port's own initialisation, TRAIN_FRESH_STEPS steps at the recipe."""
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.nn import init_parameters
    from hyres_tpu_torch.train import make_train_step

    import numpy as np

    model = init_parameters(ResidualJPEGCompression(128, 192, 1),
                            torch.Generator().manual_seed(0)).to(dev)
    state = _train_state(torch, model)
    step = make_train_step(state, TRAIN_LMBDA)
    gen = torch.Generator(dev).manual_seed(1)
    losses = []
    for _ in range(TRAIN_FRESH_STEPS):
        m = step(torch.from_numpy(_crops(np, rng, images, TRAIN_B)).to(dev), gen, True)
        check(float(m["skipped_nonfinite"]) == 0 and math.isfinite(float(m["loss"])),
              f"fresh step {len(losses)}: skipped or not finite")
        losses.append(float(m["loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"fresh initialisation: loss of the last 5 steps {last} not below "
          f"the first 5's {first}")
    log("train", f"fresh initialisation, {TRAIN_FRESH_STEPS} steps: losses "
        f"{[round(v, 3) for v in losses]}; mean of the first 5 {first:.4f}, last 5 {last:.4f}")
    return {"losses": losses}


def _entry_point(torch, x, images, dev: str) -> dict:
    """(d) cli.training in process: 2 epochs of 3 steps from the artifact
    (--pretrained), a resumed epoch, cli.updata, a device-coder roundtrip."""
    import numpy as np

    from hyres_tpu_torch.cli import training as cli_training
    from hyres_tpu_torch.cli import updata as cli_updata
    from hyres_tpu_torch.models.hyres import HyresCodec
    from hyres_tpu_torch.utils.png import write_png

    work = ROOT / "smoke_out" / "train"
    ds = work / "dataset"
    for split in ("train", "test"):
        (ds / split).mkdir(parents=True, exist_ok=True)
    base = (images[0] * 255.0 + 0.5).astype(np.uint8)
    variants = [base, base[:, ::-1], base[::-1], np.rot90(base), np.rot90(base, 3),
                base[::-1, ::-1]]
    for i, v in enumerate(variants):
        write_png(ds / "train" / f"{i}.png", np.ascontiguousarray(v))
    for i, v in enumerate(variants[:2]):
        write_png(ds / "test" / f"{i}.png", np.ascontiguousarray(v))
    ck = work / "ckpt"
    common = ["-d", str(ds), "--device", dev, "--batch-size", "2", "--test-batch-size",
              "2", "--steps-per-epoch", "3", "--num-workers", "4", "--savepath", str(ck)]
    t = time.perf_counter()
    cli_training.main(common + ["-e", "2", "--pretrained", "--checkpoint", str(ARTIFACT)])
    last = sorted(ck.glob("checkpoint_last_*.msgpack"))
    check([p.name for p in last] == ["checkpoint_last_1.msgpack"],
          f"training CLI left {[p.name for p in last]}")
    cli_training.main(common + ["-e", "3", "--checkpoint", str(last[0])])
    last = sorted(ck.glob("checkpoint_last_*.msgpack"))
    check([p.name for p in last] == ["checkpoint_last_2.msgpack"],
          f"resumed training CLI left {[p.name for p in last]}")
    train_s = time.perf_counter() - t
    cli_updata.main(["--filepath", str(last[0]), "--name", "trained", "--dir", str(work)])
    codec = HyresCodec.from_artifact(work / "trained.msgpack", device=dev, coder="device")
    comp, dec, _, _ = _roundtrip(torch, codec, x)
    for a, b in zip(comp["symbols"], dec["symbols"]):
        check(np.array_equal(_np(a), _np(b)), "trained artifact: decoded symbols differ")
    bpp = _nbytes(comp) * 8.0 / (x.shape[1] * x.shape[2])
    psnr = _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    log("train", f"cli.training: 2 epochs of 3 steps from --pretrained on the artifact, then "
        f"1 resumed epoch ({train_s:.1f} s); cli.updata baked it; device-coder roundtrip of "
        f"the original image: symbols exact, bpp {bpp!r}, psnr {psnr!r} dB")
    return {"train_s": train_s, "bpp": bpp, "psnr": psnr}


def phase_train(torch, x, codec_f32, smi: str, dev: str = "cuda") -> dict:
    """The training path at the recipe (N=128, M=192, q=1, 16x256x256):
    (a) steps in f32 and bf16, (b) the card's step against the CPU's,
    (c) a fresh initialisation's falling loss, (d) the training CLI to a
    served artifact, (e) serving bytes unchanged after training."""
    import numpy as np

    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    flags = _cudnn_flags(torch)
    _, params, _ = load_artifact(ARTIFACT)
    img = x[0].cpu().numpy()
    images = [img, img[:, ::-1], img[::-1]]
    rng = np.random.default_rng(2026)
    batches = [_crops(np, rng, images, TRAIN_B) for _ in range(4)]
    out = {"recipe": _train_recipe(torch, params, batches, smi, dev)}
    out["jpeg"] = _jpeg_pieces(torch, batches[0], dev)
    for name in ("f32", "bf16"):
        share = out["jpeg"]["device_ms"]["jpeg_roundtrip"] / out["recipe"][name]["median_ms"]
        log("train", f"{name}: the JPEG layer (K1, K2, colour, rate) is {share:.4f} of a step")
    out["card_vs_cpu"] = _card_vs_cpu(torch, params, batches[1][:2], dev)
    out["fresh"] = _fresh(torch, images, rng, dev)
    out["cli"] = _entry_point(torch, x, images, dev)
    check(_cudnn_flags(torch) == flags, f"training changed the process-wide flags: "
          f"{flags} -> {_cudnn_flags(torch)}")
    comp, dec, _, _ = _roundtrip(torch, codec_f32, x)
    bpp = _nbytes(comp) * 8.0 / (x.shape[1] * x.shape[2])
    psnr = _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    check(bpp == SERVE_F32["bpp"] and psnr == SERVE_F32["psnr"],
          f"serving after training: bpp {bpp!r}, psnr {psnr!r}, not {SERVE_F32}")
    log("train", f"serving after training: f32 device-coder bpp {bpp!r}, psnr {psnr!r} dB "
        f"(unchanged, bit for bit); process-wide flags unchanged {flags}")
    return out


def phase_profile(torch, codecs, x) -> dict:
    """Where a request's time goes: one traced compress and decompress per
    precision; device busy time (summed device work) against wall time."""
    out = {}
    for (coder, prec), codec in codecs.items():
        name = f"{coder} {prec}"
        comp = codec.compress(x)
        for step, fn in (("compress", lambda: codec.compress(x)),
                         ("decompress", lambda: codec.decompress(comp))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prof, _ = _profile(torch, fn)
            wall_ms = (time.perf_counter() - t) * 1e3
            busy_ms = sum(_dev_us(e) for e in prof.events()
                          if e.device_type.name == "CUDA") / 1e3
            by_op = sorted(((_dev_us(a, "self_device_time_total"), a.key)
                            for a in prof.key_averages()
                            if a.key.startswith("aten::")), reverse=True)[:4]
            top = ", ".join(f"{k} {us / 1e3:.2f} ms" for us, k in by_op)
            out[f"{name}/{step}"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                     "top_ops": [[k, us / 1e3] for us, k in by_op]}
            log("profile", f"{name} {step}: wall {wall_ms:.2f} ms (traced), "
                f"device busy {busy_ms:.2f} ms, idle share "
                f"{1 - busy_ms / wall_ms:.2f}; top: {top}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs only on a "
              "GPU", file=sys.stderr)
        return 1
    if not (ROOT / "hyres_tpu_torch").is_dir() or not ARTIFACT.exists():
        print("chip_smoke: run from a checkout of the repository (the package, "
              "artifact and image must sit beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    try:
        smi, kind, sm_mhz = phase_device(torch)
        phase_build()

        from hyres_tpu_torch.utils.png import load_image

        from hyres_tpu_torch.models.hyres import HyresCodec

        x = torch.from_numpy(load_image(IMAGE)).cuda()
        kstats = phase_kernels(torch, x)
        codecs = {(coder, name): HyresCodec.from_artifact(
            ARTIFACT, compute_dtype=dt, device="cuda", coder=coder)
            for coder in CODERS
            for name, dt in (("bf16", torch.bfloat16), ("f32", None))}
        log("coder", "artifact loaded")
        cstats = phase_coder(torch, codecs[("device", "f32")], x, sm_mhz)
        main_out = phase_main(torch, x, codecs)
        main_out["serve"] = phase_serve(torch, x, codecs, smi)
        main_out["train"] = phase_train(torch, x, codecs[("device", "f32")], smi)
        main_out["profile"] = phase_profile(torch, codecs, x)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    launches = main_out["launches"]["device"]  # the path that runs all five
    kernels = [
        {"name": name, "route": "cuda",
         "source": "hyres_tpu_torch/kernels/csrc/dct.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": kstats[k]["max_abs_err"], "ms": kstats[k]["ms"],
         "plain_ms": kstats[k]["plain_ms"], "bound_ms": kstats[k]["bound_ms"],
         "bound_by": kstats[k]["bound_by"], "library_ms": None}
        for k, name, replaces in (
            ("K1", "fdct_quant_blocks", "hyres_tpu/kernels/dct.py:44"),
            ("K2", "dequant_idct_blocks", "hyres_tpu/kernels/dct.py:53"))]
    kernels += [
        {"name": name, "route": "cuda",
         "source": "hyres_tpu_torch/kernels/csrc/rans.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": cstats[k]["max_abs_err"], "ms": cstats[k]["ms"],
         "plain_ms": cstats[k]["plain_ms"], "bound_ms": cstats[k]["bound_ms"],
         "bound_by": cstats[k]["bound_by"], "library_ms": None}
        for k, name, replaces in (
            ("K3", "encode_planes", "hyres_tpu/coding/pallas_rans.py:679"),
            ("K4", "gauss_decode", "hyres_tpu/coding/pallas_rans.py:179"),
            ("K5", "eb_decode", "hyres_tpu/coding/pallas_rans.py:443"))]
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": kstats, "coder": cstats, "main": main_out},
        indent=1))
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
