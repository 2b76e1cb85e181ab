#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hyres_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --gmm    # device, build and the mixture variant alone
    python3 chip_smoke.py --tcm    # device, build and the TCM phase alone

Phases, each printing one line with its elapsed seconds:

1. device  -- the card's name and power limit (nvidia-smi), device count.
2. build   -- nvcc build of the CUDA kernels (dct, rans, window_attn) and
              g++ build of the host coding library, from the sources in
              this checkout.
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
              or K5, held against the plain versions on CPU copies. And
              ``tpu_rans``'s entry points under their names on the
              request's planes: ``fused_encode_planes`` as one K3 launch
              under sync-debug "error", ``gauss_encode_batch`` and
              ``rans_encode_batch`` a launch each, equal to the plain K3
              and to the frames above; ``gauss_decode_batch`` (K4) and
              ``rans_decode_batch`` (K5) equal to the plain decodes.
5. main    -- the HyRES deployment roundtrip (``HyresCodec.compress`` then
              ``decompress``) on the trained artifact at full width (N=128,
              M=192, JPEG quality 1), serving three requests (an in-repo
              768x512 image, its horizontal and its vertical flip) in
              bfloat16 and in float32, first with the host rANS coder, then
              with the device coder (K3-K5). Each path runs with the launch
              counts set to 0 just before it and read just after: K1
              exactly once a roundtrip and K2 exactly twice on both, K3-K5
              (and not K6 or the mixture decode) on the second, which must
              also re-frame nothing with the host coder and count one
              overlapped JFIF parse a decompress. Then one compress and decompress a precision
              under sync-debug "warn" print their synchronising calls.
              Every decoded symbol must equal the coded one, and the
              float32 bpp/PSNR of the original image must lie within 1% /
              0.05 dB of the JAX reference's numbers for the same coder.
              Then a large batch in a child process under a 300 s wall
              (a hang fails the phase, not the run): 8 2x2 mosaics
              (1536x1024) of the image and its flips in f32 on each coder
              (a y half is 8 host chunks), 3 batch roundtrips with the
              launch counts set to 0 just before and read just after (K1
              1, K2 2, and K3 1, K4 2, K5 1 on the device coder, a
              roundtrip), symbols exact, no host fallback, each image's
              bytes equal to the coder's B=1 call on its symbols and
              rows.
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
              ``total_bpp`` and ``psnr``. Then the coder's wire: each device
              codec's high-water marks cleared, four requests (the image,
              its flips, the image again) with each one's pulls, pulled and
              uploaded bytes and plan; the first takes the full-cap pull
              (1,285,400 bytes), the last the speculative plan (one pull,
              fewer bytes), and none falls back.
7. train   -- the training path at the recipe (N=128, M=192, JPEG quality
              1, batch 16 of 256x256 crops of the image and its flips):
              (a) 3 warm-up and 10 timed steps from the artifact's weights in
              f32 and in bf16, the timed steps under sync-debug "error"
              (ms a step, peak memory, each step's metrics,
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
8. refine  -- the rest of the HyRES pipeline at full width: (a) 3 warm-up
              and 10 timed refinement steps (``cli/refine_training.py
              make_refine_step``: the codec frozen, MSE x 255^2, Adam on
              the refinement) from the artifact at the recipe in f32, the
              timed steps under sync-debug "error" (ms a
              step, peak memory, losses finite, K1/K2 exactly once a step,
              every leaf outside ``refine.*`` equal bit for bit, a refine
              leaf moved, a traced step's idle share and top operations);
              (b) the first step at batch 2 on the card against the CPU
              with the plain K1/K2 (loss rel 1e-4, each refine gradient
              leaf 1e-3 of its max |g|); (c) ``cli.refine_training`` in
              process (2 epochs of 3 steps on seeded crops of the image and
              its flips) and ``cli.refine_inference`` with its best
              checkpoint, with and without --skip-postprocessing, each
              printed PSNR and PNG equal to the same forward in process;
              (d) the refined weights in the f32 device-coder codec:
              strings and JFIF bytes identical, the new PSNR beside the
              old, then the artifact's refinement back at bpp
              1.6257731119791667 / PSNR 33.63140531071406 dB bit for bit
              and the process-wide flags unchanged; (e) ``JpegCodec``:
              ``compress`` byte-equal to ``HyresCodec``'s JFIF buffers with
              one K1 launch, ``decompress`` equal to ``decode_jpeg`` with
              one K2 launch, its bpp the file's scan-bit rate; (f)
              ``VGGLoss`` and ``LPIPS`` on the card against the CPU on
              seeded ``.npz`` weights (rel 1e-4), ``cli.training --alpha
              0.01 --allow-random-vgg`` from the artifact in f32 and bf16
              (every step finite, none skipped, the VGG term above 0), a
              recipe step with and without the VGG term in alternating
              turns, and ``CompressionMetrics`` on the f32 device-coder
              roundtrip giving the main phase's PSNR. Prints its seconds.
9. baselines -- the ELIC (N=192, M=320, groups 16/16/32/64/192) and
              Cheng2020 (N=M=192) families at their published widths on
              seeded weights (flax's initialisers, the scales' output bias
              at 2.0 and the factorized prior fit to a crop's z, so that the
              random model's planes fit the device coder's buffers). Per
              family: ``update()`` bakes once; the original image, its
              horizontal flip and a 256x256 crop through ``compress`` /
              ``decompress`` in f32 and bf16 on each coder, the launch counts
              set to 0 just before a coder's path and read just after (host:
              none; device: per roundtrip one K3 over every plane, ELIC's
              11, K4 a y plane, K5 once, each at the lanes its frames name,
              from ``kernels/rans.py LAUNCH_SHAPES``), no host fallback,
              symbols exact; the dispatch halves under sync-debug "error"
              and a full device request's synchronising calls (none); the
              wire as in serve (a full-cap first pull, the speculative
              plan on the repeated request, no fallback); walls
              (median of 3); ``inference_stream`` depth 2 equal to
              sequential requests; a traced request a precision; K3 over a
              request's planes and K4/K5 at each lane tier against their
              plain versions on CPU copies, timed beside their bounds; the
              f32 device roundtrip of the crop on the card against the CPU
              (at most 0.1% of symbols apart, bpp within 0.5%, PSNR within
              0.02 dB); 4 training steps at the recipe (16 x 256x256, f32),
              finite, the loss falling, with ms a step and peak memory; and
              ``cli.updata`` -> ``cli.codec`` (PNG byte-equal to the
              in-process decode) -> ``cli.inference`` (its bpp) and one
              epoch of ``cli.training``. Then Cheng2020 with attention and
              a 3-component Gaussian mixture (N=M=192; each component's
              mean bias apart, the scales' at 1.5) on the device coder in
              f32: the image and its flip, the launch counts set to 0
              just before and read just after (a roundtrip: one K3, one
              K5, four K6 ``gmm_rows``, two ``gmm_decode``), symbols
              exact, no fallback; K6 and the mixture decode on the inputs
              that path gave them (147,456 rows a plane, 128 lanes), bit
              for bit against ``gmm_rows_ref`` / ``gmm_decode_ref`` on CPU
              copies, timed beside their bytes bounds.
10. tcm    -- K7 (``window_attention``) at the five attention shapes of a
              768x512 TCM request (g_a's three stages, g_s's the same;
              SWAtten on y; h_a and h_s at window 4), W and SW, within 2e-5
              of its plain version computed in float64 on CPU copies, timed
              beside its bound (qkv read once, the output written once, the
              bias table once, or QK^T and PV at the FP32 peak) and the plain
              version on the card; then TCM at N=128, M=320 on seeded
              weights on the device coder: the window's counters set to 0,
              three roundtrips of a 768x512 window of the image (op by op,
              capturing the dispatch graph, replaying it), each 32 K7
              launches a compress and 30 a decompress, symbols exact, no
              host fallback.
11. profile -- one traced compress and decompress per coder and precision.
12. convert -- the artifact's weights written as a reference training
              checkpoint (``torch.save`` of ``{"epoch", "state_dict",
              "optimizer"}``, CompressAI names from ``utils/torch_convert.py
              export_hyres``, plus a stray ``se_block.*`` key and the
              entropy coders' buffers), read back by ``load_pth`` and
              ``convert_hyres``: the tree equals the artifact's leaf for
              leaf. ``HyresCodec(coder="device")`` of it, with a fresh
              ``update()``, serves the three requests in f32 with launches
              1/2/1/2/1 a roundtrip for K1-K5 (counts set to 0 just before,
              read just after): strings and JFIF bytes identical and
              ``x_hat`` ``torch.equal`` to a codec of the artifact's params
              with the same fresh ``update()``; bpp within 0.5% and PSNR
              within 0.02 dB of the artifact's baked tables.
13. parallel -- ``parallel/`` on a single-rank NCCL group (``HYRES_MULTIHOST=1``):
              a DP train step at the recipe (16 x 256x256, f32, the
              artifact's weights) against the plain step from the same
              state and generator seed (loss rel 1e-4, each gradient leaf
              1e-3 of its max |g|, K1/K2 once), then 10 steps of each in
              alternating turns (ms a step and the flat all-reduce's bytes,
              not gated); ``make_sharded_eval`` on the three images against
              ``make_eval_step``'s forward (psnr and bpp_est rel 1e-4);
              ``strip_forward`` of the artifact's residual model, strips 0
              and 1 of 2 with a halo of 64 rows on the image's JPEG
              residual, against the unsharded forward under the coder
              path's flags (mean abs err < 1e-3, share of elements off by
              more than 1e-2 under 2%; the interior maximum printed).

The last lines are the card's nvidia-smi line, one JSON object with the
kernels' launches and times, and ``{"ok": true, "device": ...}``. The
full measurements go to ``smoke_out/chip_smoke.json`` (``--gmm``, ``--tcm``:
``smoke_out/chip_smoke_gmm.json``, ``smoke_out/chip_smoke_tcm.json``). Any
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

    built = build.build_all()
    check({"hyres_dct", "hyres_rans", "hyres_window_attn", "hyres_coding"} <= set(built),
          f"build: built {sorted(built)}")
    for name, (path, secs) in built.items():
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


def _sync_free(torch, fn):
    """fn() under sync-debug "error": a synchronising call raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


FULL_CAP_PULL = 1285400  # a 768x512 HyRES request's planes at full caps + int8 coefficients


def _wire(torch, owner, call, requests, label: str, phase: str) -> list:
    """Each request through ``call`` (a compress and a decompress) with the
    high-water marks of ``owner`` (the codec holding ``_enc_cap_state``)
    cleared first: per request its pulls, pulled and uploaded bytes and
    the plan of its pull. The first takes the full-cap pull; the last
    repeats the first, inside the marks, so it must take the speculative
    plan: one pull. No request may fall back to the host coder."""
    from hyres_tpu_torch.models import codec as tcodec

    owner.__dict__.pop("_enc_cap_state", None)
    rows = []
    for xr in requests:
        marked = bool(owner.__dict__.get("_enc_cap_state"))
        tcodec.reset_wire_stats()
        call(xr)
        w = tcodec.WIRE_STATS
        plan = ("full-cap" if not marked else "speculative" if w["d2h_syncs"] == 1
                else "speculative, missed, exact re-pull")
        rows.append({"plan": plan, "pulls": w["d2h_syncs"], "d2h_bytes": w["d2h_bytes"],
                     "h2d_bytes": w["h2d_bytes"], "host_fallbacks": w["host_fallbacks"]})
    first, last = rows[0], rows[-1]
    check(first["plan"] == "full-cap" and last["plan"] == "speculative"
          and not any(r["host_fallbacks"] for r in rows), f"{label}: wire {rows}")
    log(phase, f"{label} wire a request (plan, pulls, d2h bytes, h2d bytes): "
        + "; ".join(f"{r['plan']}, {r['pulls']}, {r['d2h_bytes']}, {r['h2d_bytes']}"
                    for r in rows))
    return rows


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

    dc = codec.device_coder
    with torch.inference_mode():
        z_sym, ((a_sym, a_idx), (n_sym, n_idx)) = codec.latents(x)
    jobs = codec.device_jobs(z_sym, [(a_sym, a_idx), (n_sym, n_idx)])
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
    plain_dec = {}
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
        plain_dec[label] = w[:, :n]
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
    out["batch_api"] = _batch_api(
        torch, dc, [("eb", z_sym, dc._z_idx(z_sym.shape, x.device), dc.eb, jobs[0].lanes),
                    ("gauss", a_sym, a_idx, dc.gauss, jobs[1].lanes),
                    ("gauss", n_sym, n_idx, dc.gauss, jobs[2].lanes)],
        labels, want, frames, plain_dec)
    out["high_rate"] = _high_rate_plane(torch, codec)
    return out


def _batch_api(torch, dc, specs, labels, plain_enc, frames, plain_dec) -> dict:
    """``tpu_rans``'s entry points under their names on the request's
    planes: ``fused_encode_planes`` as ONE K3 launch under sync-debug
    "error", ``gauss_encode_batch`` / ``rans_encode_batch`` a launch each,
    all equal to the plain K3's words and to the encode path's frames;
    ``gauss_decode_batch`` (K4) and ``rans_decode_batch`` (K5) of those
    frames equal to the plain decodes and the coded symbols."""
    import numpy as np

    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models.codec import DevicePlaneCoder

    planes = [(kind, sym.reshape(1, -1), idx.reshape(1, -1), tab, lanes)
              for kind, sym, idx, tab, lanes in specs]
    torch.cuda.synchronize()
    before = dict(krans.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = dr.fused_encode_planes(planes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 1,
          "fused_encode_planes: not one K3 launch")
    single = [(dr.gauss_encode_batch if kind == "gauss" else dr.rans_encode_batch)(
        sym, idx, tab, lanes) for kind, sym, idx, tab, lanes in planes]
    check(krans.LAUNCHES["encode_planes"] == before["encode_planes"] + 4,
          "*_encode_batch: not one K3 launch a call")
    out = {"planes": []}
    for label, (kind, _, idx, tab, lanes), f, one, (stream, states, n_renorm), fr, coded in zip(
            labels, planes, fused, single, plain_enc, frames, plain_dec.values()):
        for enc in (f, one):
            check(all(torch.equal(enc[k].cpu(), v.cpu()) for k, v in
                      (("stream", stream), ("states", states), ("n_renorm", n_renorm))),
                  f"batch API {label}: K3 words differ from the plain version's")
            check(DevicePlaneCoder.frames_from_enc({k: v.cpu().numpy() for k, v in enc.items()})
                  == fr, f"batch API {label}: frames differ from the encode path's")
        n = idx.shape[1]
        lanes_f, st, sm, ep, ev = DevicePlaneCoder.unframe_batch(fr, n)
        decode = dr.gauss_decode_batch if kind == "gauss" else dr.rans_decode_batch
        k = "gauss_decode" if kind == "gauss" else "eb_decode"
        b = krans.LAUNCHES[k]
        got = decode(torch.from_numpy(sm.view(np.int16)).cuda(),
                     torch.from_numpy(st.view(np.int32)).cuda(), idx,
                     torch.from_numpy(ep).cuda(), torch.from_numpy(ev).cuda(), tab, lanes_f, n)
        torch.cuda.synchronize()
        check(krans.LAUNCHES[k] == b + 1, f"batch API {label}: not one {k} launch")
        check(torch.equal(got.cpu(), coded.cpu()),
              f"batch API {label}: {decode.__name__} differs from the plain decode")
        out["planes"].append({"plane": label, "kind": kind, "lanes": lanes, "n": n,
                              "bytes": len(fr[0])})
        log("coder", f"batch API {label}: fused_encode_planes (one K3 for the three planes) "
            f"and {'gauss' if kind == 'gauss' else 'rans'}_encode_batch equal to the plain "
            f"K3 and the encode path's frames ({len(fr[0])} bytes); {decode.__name__} "
            "exact against the plain version")
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

    dc = codec.device_coder
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
        # each decompress parses its JFIF bytes behind its queued decode chain
        # on the device coder's path, and on no other
        parses = tcodec.WIRE_STATS["overlapped_parses"]
        check(parses == (n_rt if coder == "device" else 0),
              f"{coder} coder: {parses} overlapped parses in {n_rt} roundtrips")
        if coder == "device":
            # K3-K5; K6 and the mixture decode are Cheng2020's alone
            for k in krans.LAUNCHES:
                on_path = not k.startswith("gmm_")
                check((launches[k] > 0) == on_path, f"kernel {k} launched {launches[k]} "
                      f"times on the {coder}-coder path")
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
    out["large_batch"] = _large_batch(torch)
    return out


LARGE_B = 8              # the large batch: 8 images of 1536x1024
LARGE_REPS = 3           # timed batch roundtrips a coder (median)
LARGE_TIMEOUT_S = 300    # the child process's wall: a hang fails the phase


def _mosaics(torch, x, n: int):
    """n 2x2 mosaics (2H x 2W) of the image and its three flips, each in
    another order."""
    tiles = [x, x.flip(2), x.flip(1), x.flip(1).flip(2)]
    out = []
    for k in range(n):
        order = [tiles[(k + j) % 4] for j in range(4)]
        if k >= 4:
            order = order[::-1]
        out.append(torch.cat([torch.cat(order[:2], dim=2), torch.cat(order[2:], dim=2)],
                             dim=1))
    return torch.cat(out).contiguous()


def _large_batch(torch) -> dict:
    """The large-batch step in a child process (``--large-batch``) under
    a wall of ``LARGE_TIMEOUT_S``, so that a hang fails this phase rather
    than the run."""
    out_path = ROOT / "smoke_out" / "large_batch.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--large-batch",
                               str(out_path)], cwd=ROOT, capture_output=True, text=True,
                              timeout=LARGE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        print(e.stdout or "", end="", flush=True)
        raise SmokeFailure(f"large batch: no result within {LARGE_TIMEOUT_S} s") from None
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0 and out_path.exists(),
          f"large batch: child exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(out_path.read_text())


def large_batch_child(out_path: Path) -> int:
    """``LARGE_B`` 2x2 mosaics (1536x1024) of the image and its flips
    through ``HyresCodec`` from the trained artifact at full width, in
    f32, on the host coder and then on the device coder: a warm-up
    roundtrip, then ``LARGE_REPS`` batch roundtrips with the launch counts
    set to 0 just before and read just after (K1 once and K2 twice a
    roundtrip; K3 once, K4 twice and K5 once on the device coder, which
    re-frames nothing). Every decoded symbol equals the coded one; each
    image's bytes equal the coder's B=1 call on that image's symbols and
    rows (the batch's own stages). Whole single-image requests are left
    to ``scripts/torch_batch_decode.py``: cuDNN may sum a batch of one in
    another order, so their scale indexes can differ from the batch's."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec
    from hyres_tpu_torch.models.hyres import HyresCodec
    from hyres_tpu_torch.utils.png import load_image

    try:
        xb = _mosaics(torch, torch.from_numpy(load_image(IMAGE)).cuda(), LARGE_B)
        res = {"shape": list(xb.shape), "coders": {}}
        for coder in CODERS:
            codec = HyresCodec.from_artifact(ARTIFACT, device="cuda", coder=coder)
            _roundtrip(torch, codec, xb)
            dct.reset_launches()
            krans.reset_launches()
            tcodec.reset_wire_stats()
            runs = [_roundtrip(torch, codec, xb) for _ in range(LARGE_REPS)]
            launches = {**dct.LAUNCHES, **krans.LAUNCHES}
            want = {"fdct_quant_blocks": 1, "dequant_idct_blocks": 2,
                    "encode_planes": 0, "gauss_decode": 0, "eb_decode": 0,
                    "gmm_rows": 0, "gmm_decode": 0}
            if coder == "device":
                want.update(encode_planes=1, gauss_decode=2, eb_decode=1)
            check(launches == {k: LARGE_REPS * v for k, v in want.items()},
                  f"{coder} coder: launches {launches} in {LARGE_REPS} batch roundtrips")
            check(tcodec.WIRE_STATS["host_fallbacks"] == 0,
                  f"{coder} coder re-framed with the host coder: "
                  f"{tcodec.WIRE_STATS['fallback_reasons']}")
            comp, dec = runs[-1][:2]
            for a, b in zip(comp["symbols"], dec["symbols"]):
                check(np.array_equal(_np(a), _np(b)),
                      f"{coder} large batch: decoded symbols differ from the coded ones")
            with torch.inference_mode():
                z_sym, ((a_sym, a_idx), (n_sym, n_idx)) = codec.latents(xb)
            for a, b in zip(comp["symbols"], (z_sym, a_sym, n_sym)):
                check(np.array_equal(_np(a), _np(b)),
                      f"{coder} large batch: the stages gave other symbols on a second run")
            (a_str, n_str), z_str = comp["strings"]
            for i in range(LARGE_B):
                one = [_np(t[i:i + 1]) if coder == "host" else t[i:i + 1]
                       for t in (z_sym, a_sym, a_idx, n_sym, n_idx)]
                if coder == "host":
                    z1 = codec._eb_encode(one[0])
                    a1 = tcodec._encode_planes(one[1], one[2], codec.gauss_tables)
                    n1 = tcodec._encode_planes(one[3], one[4], codec.gauss_tables)
                else:
                    jobs = codec.device_jobs(one[0], [(one[1], one[2]), (one[3], one[4])])
                    z1, a1, n1 = (codec.device_coder.frames_from_enc(
                        {k: v.cpu().numpy() for k, v in e.items()})
                        for e in dr.encode(jobs))
                check((z1[0], a1[0], n1[0]) == (z_str[i], a_str[i], n_str[i]),
                      f"{coder} large batch: image {i}'s bytes differ from the coder's "
                      "B=1 call")
            c_ms = sorted(t_c * 1e3 for _, _, t_c, _ in runs)[LARGE_REPS // 2]
            d_ms = sorted(t_d * 1e3 for _, _, _, t_d in runs)[LARGE_REPS // 2]
            nbytes = _nbytes(comp)
            res["coders"][coder] = {"compress_ms": c_ms, "decompress_ms": d_ms,
                                    "launches": launches, "bytes": nbytes,
                                    "host_chunks_y_half": tcodec._n_chunks(a_sym[0].numel())}
            log("main", f"large batch, {coder} coder, f32, {LARGE_B} x {tuple(xb.shape[1:3])}: "
                f"compress {c_ms:.2f} ms, decompress {d_ms:.2f} ms a batch (median of "
                f"{LARGE_REPS}), {nbytes} bytes, launches {launches}, symbols exact, each "
                f"image's bytes equal the coder's B=1 call; host chunks a y half "
                f"{tcodec._n_chunks(a_sym[0].numel())}")
            del codec, runs, comp, dec
            torch.cuda.empty_cache()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    out_path.write_text(json.dumps(res, indent=1))
    return 0


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
                    "encode_planes": n, "gauss_decode": 2 * n, "eb_decode": n,
                    "gmm_rows": 0, "gmm_decode": 0}
            check(launches == want, f"{label} stream depth {depth}: launches {launches}, "
                  f"not {want}")
            out["launches"][f"{label} depth {depth}"] = launches
        log("serve", f"{label}: inference_stream depth 2 and 3 over {n} requests equal "
            f"to sequential inference (bytes, x_hat); launches {launches}")
        rows = _wire(torch, codec, lambda xr: codec.decompress(codec.compress(xr)),
                     base + [x], label, "serve")
        check(rows[0]["d2h_bytes"] == FULL_CAP_PULL and rows[-1]["d2h_bytes"] < FULL_CAP_PULL,
              f"{label}: full-cap pull {rows[0]['d2h_bytes']} bytes, not {FULL_CAP_PULL}, "
              f"or the steady state's {rows[-1]['d2h_bytes']} not below it")
        out.setdefault("wire", {})[label] = rows

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
# the median steps measured while the NaN guard still read its flag on the
# host (an earlier chip call, possibly on another card), printed beside these
HOST_READ_STEP_MS = {"f32": 214.97, "bf16": 127.93}
HOST_READ_REFINE_STEP_MS = 102.81
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


def _traced_step(torch, fn) -> tuple:
    """One traced call: (wall ms, device busy ms, the top six aten ops and
    the hand-written DCT kernels by self device us)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    prof, _ = _profile(torch, fn)
    traced = (time.perf_counter() - t) * 1e3
    busy = sum(_dev_us(e) for e in prof.events() if e.device_type.name == "CUDA") / 1e3
    by_op = sorted(((_dev_us(a, "self_device_time_total"), a.key)
                    for a in prof.key_averages() if a.key.startswith("aten::")),
                   reverse=True)[:6]
    mine = sorted(((_dev_us(a, "self_device_time_total"), a.key)
                   for a in prof.key_averages() if "dct_kernel" in a.key), reverse=True)
    return traced, busy, by_op, mine


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
            ms, m = _timed_once(torch, lambda: _sync_free(
                torch, lambda: step(xs[i % len(xs)], gen, True)))
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
        log("train", f"{name} step at B={TRAIN_B}, {TRAIN_P}x{TRAIN_P}, under sync-debug "
            f"\"error\": median {srt[len(srt) // 2]:.2f} ms, range {srt[0]:.2f}-{srt[-1]:.2f} "
            f"ms over {TRAIN_TIMED} steps ({smi}; with the host read, another call on "
            f"possibly another card: {HOST_READ_STEP_MS[name]} ms); peak memory "
            f"{peak / 2**30:.2f} GiB; K1/K2 launches {launches} (1 and 1 a micro-step)")
        for i, m in enumerate(mets):
            log("train", f"{name} step {i}: loss {m['loss']:.4f} bpp {m['bpp_loss']:.4f} "
                f"mse {m['mse_loss']:.3f} aux {m['aux_loss']:.2f}")
        traced, busy, by_op, mine = _traced_step(torch, lambda: step(xs[0], gen, True))
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


# -- refine --------------------------------------------------------------------

REFINE_LR = 1e-4                 # cli/refine_training.py's default
VGG_ALPHA = 0.01
LOSS_RTOL = 1e-4                 # VGGLoss / LPIPS on the card against the CPU
VGG_GRAD_L2 = 1e-2               # VGGLoss's gradient into x, card/CPU, relative L2 norm
PSNR_METRIC_ATOL_DB = 1e-4       # CompressionMetrics' float32 PSNR against the float64 one


def _refine_model(torch, params, dev):
    """The artifact's model with the codec frozen, and its refinement step
    (Adam at REFINE_LR, clip 1.0 over the refine gradients)."""
    from hyres_tpu_torch.cli.refine_training import freeze_codec, make_refine_step
    from hyres_tpu_torch.train.optimizers import adam

    model = _recipe_model(torch, params, None, dev)
    opt = adam(freeze_codec(model), REFINE_LR)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    return model, make_refine_step(model, opt)


def _refine_steps(torch, params, batches, smi: str, dev: str) -> dict:
    """(a) Refinement steps at the recipe in f32: times, memory, losses,
    K1/K2 launches a step, the frozen codec bit for bit, a traced step."""
    from hyres_tpu_torch.kernels import dct

    model, step = _refine_model(torch, params, dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    xs = [torch.from_numpy(b).to(dev) for b in batches]
    for i in range(TRAIN_WARMUP):
        step(xs[i % len(xs)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dct.reset_launches()
    times, mets = [], []
    for i in range(TRAIN_TIMED):
        ms, m = _timed_once(torch, lambda: _sync_free(torch, lambda: step(xs[i % len(xs)])))
        times.append(ms)
        mets.append({k: float(v) for k, v in m.items()})
    launches = dict(dct.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"fdct_quant_blocks": TRAIN_TIMED, "dequant_idct_blocks": TRAIN_TIMED},
          f"refine: {TRAIN_TIMED} steps launched K1/K2 {launches} times")
    check(all(m["skipped_nonfinite"] == 0 and math.isfinite(m["loss"]) for m in mets),
          f"refine: a step was skipped or not finite: {mets}")
    moved = [n for n, p in model.named_parameters() if not torch.equal(start[n], p.detach())]
    check(bool(moved) and all(n.startswith("refine.") for n in moved),
          f"refine: the steps moved {[n for n in moved if not n.startswith('refine.')]} "
          f"outside refine.*, or no refine leaf ({len(moved)} moved)")
    n_frozen = sum(1 for n in start if not n.startswith("refine."))
    srt = sorted(times)
    med = srt[len(srt) // 2]
    log("refine", f"f32 step at B={TRAIN_B}, {TRAIN_P}x{TRAIN_P}, under sync-debug "
        f"\"error\": median {med:.2f} ms ({TRAIN_B * 1e3 / med:.1f} images/s), range "
        f"{srt[0]:.2f}-{srt[-1]:.2f} ms over {TRAIN_TIMED} steps ({smi}; with the host "
        f"read, another call on possibly another card: {HOST_READ_REFINE_STEP_MS} ms); "
        f"peak memory {peak / 2**30:.2f} GiB; K1/K2 launches "
        f"{launches} (1 and 1 a step); {n_frozen} frozen leaves bit for bit, "
        f"{len(moved)} refine leaves moved; losses "
        + ", ".join(f"{m['loss']:.3f}" for m in mets))
    traced, busy, by_op, mine = _traced_step(torch, lambda: step(xs[0]))
    log("refine", f"f32 traced step: wall {traced:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {1 - busy / traced:.3f}; top: "
        + ", ".join(f"{k} {us / 1e3:.2f} ms" for us, k in by_op)
        + "; hand-written: " + ", ".join(f"{k} {us / 1e3:.4f} ms" for us, k in mine))
    return {"step_ms": times, "median_ms": med, "peak_bytes": peak, "metrics": mets,
            "launches": launches, "moved": len(moved), "frozen": n_frozen,
            "traced_wall_ms": traced, "device_busy_ms": busy,
            "top_ops": [[k, us / 1e3] for us, k in by_op],
            "kernels": [[k, us / 1e3] for us, k in mine]}


def _refine_card_vs_cpu(torch, params, batch, dev: str) -> dict:
    """(b) The first refinement step at batch 2 on the card and on the CPU
    with the plain K1/K2: its loss and every refine gradient leaf."""
    out = {}
    for d in (dev, "cpu"):
        model, step = _refine_model(torch, params, d)
        m = step(torch.from_numpy(batch).to(d))
        out[d] = (float(m["loss"]), {n: p.grad.detach().cpu() for n, p in
                                     model.named_parameters() if n.startswith("refine.")})
    (lc, gc), (lp, gp) = out[dev], out["cpu"]
    check(abs(lc - lp) <= STEP_LOSS_RTOL * abs(lp), f"card refine loss {lc} vs CPU {lp}")
    worst = (0.0, "")
    for n in gp:
        rel = float((gc[n] - gp[n]).abs().max()) / max(float(gp[n].abs().max()), 1e-30)
        worst = max(worst, (rel, n))
    check(worst[0] <= STEP_GRAD_BAR, f"refine gradient {worst[1]}: {worst[0]:.3g} of max |g|")
    log("refine", f"card step against the CPU step (batch 2, plain K1/K2 on the CPU): loss "
        f"{lc!r} vs {lp!r} (rel {abs(lc - lp) / abs(lp):.2g}); {len(gp)} refine gradient "
        f"leaves, worst {worst[0]:.3g} of its max |g| ({worst[1]})")
    return {"loss_cuda": lc, "loss_cpu": lp, "worst_grad": list(worst)}


def _refine_dataset(np, images, rng, root: Path) -> Path:
    """Seeded crops of the image and its flips as PNGs: 12 of 320x320
    (train) and two of 256x256 (test) at the recipe's patch."""
    from hyres_tpu_torch.utils.png import write_png

    for split, n, side in (("train", 12, TRAIN_P + TRAIN_P // 4), ("test", 2, TRAIN_P)):
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = images[int(rng.integers(len(images)))]
            y0 = int(rng.integers(0, img.shape[0] - side + 1))
            x0 = int(rng.integers(0, img.shape[1] - side + 1))
            crop = (img[y0:y0 + side, x0:x0 + side] * 255.0 + 0.5).astype(np.uint8)
            write_png(root / split / f"{i}.png", np.ascontiguousarray(crop))
    return root


def _refine_clis(torch, x, ds: Path, dev: str) -> tuple[dict, Path]:
    """(c) cli.refine_training (2 epochs of 3 steps from the artifact), then
    cli.refine_inference with its best checkpoint, with and without
    --skip-postprocessing: each printed PSNR and PNG equal to the same
    forward in process."""
    import contextlib
    import io
    import shutil

    from hyres_tpu_torch.cli import refine_inference, refine_training
    from hyres_tpu_torch.cli.refine_training import load_refine
    from hyres_tpu_torch.train import load_checkpoint, restore_into
    from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
    from hyres_tpu_torch.utils.png import save_image

    work = ROOT / "smoke_out" / "refine"
    ck = work / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t = time.perf_counter()
    refine_training.main(["-d", str(ds), "--checkpoint", str(ARTIFACT), "-e", "2",
                          "--batch-size", "4", "--patch-size", str(TRAIN_P), str(TRAIN_P),
                          "--steps-per-epoch", "3", "--device", dev, "--savepath", str(ck)])
    train_s = time.perf_counter() - t
    names = sorted(p.name for p in ck.iterdir())
    best = [ck / n for n in names if n.startswith("refine_best_")]
    check(len(names) == 2 and "refine_last_1.msgpack" in names and len(best) == 1,
          f"refine CLI left {names}")
    model = ResidualJPEGCompression(128, 192, 1)
    restore_into(model, load_checkpoint(ARTIFACT))
    load_refine(model, load_checkpoint(best[0]))
    model.to(dev).eval()
    with torch.no_grad():
        out = model(x, noisequant=False)
    res = {}
    for skip in (False, True):
        png = work / f"refined_{int(skip)}.png"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            refine_inference.main(["--checkpoint", str(ARTIFACT), "--post-checkpoint",
                                   str(best[0]), "--input", str(IMAGE), "--output", str(png),
                                   "--device", dev] + (["--skip-postprocessing"] if skip else []))
        line = buf.getvalue().strip()
        x_hat = (torch.clamp(out["jpeg_decoded"] + out["residual_hat"], 0, 1) if skip
                 else out["x_hat"])
        psnr = -10 * math.log10(float(torch.mean((x - x_hat) ** 2)))  # as the CLI computes it
        check(f"psnr={psnr:.2f} " in line, f"refine_inference (skip {skip}) printed {line!r}, "
              f"the same forward in process gives psnr {psnr!r}")
        save_image(x_hat, work / "want.png")
        check(png.read_bytes() == (work / "want.png").read_bytes(),
              f"refine_inference (skip {skip}): the PNG differs from the in-process forward's")
        res["skip" if skip else "refined"] = {"line": line, "psnr": psnr}
    log("refine", f"cli.refine_training: 2 epochs of 3 steps of 4 from the artifact "
        f"({train_s:.1f} s) -> {best[0].name}; cli.refine_inference on the "
        f"{x.shape[2]}x{x.shape[1]} image: "
        f"{res['refined']['line']!r}; with --skip-postprocessing {res['skip']['line']!r} "
        "(each equal to the in-process forward)")
    return {"train_s": train_s, "best": best[0].name, **res}, best[0]


def _refine_serving(torch, x, codec, best, params) -> dict:
    """(d) The refined weights installed into the device-coder codec: the
    same strings and JFIF bytes, a new PSNR; then the artifact's own
    refinement back, at SERVE_F32 bit for bit."""
    from hyres_tpu_torch.cli.refine_training import load_refine
    from hyres_tpu_torch.train import load_checkpoint

    flags = _cudnn_flags(torch)
    comp0, dec0, _, _ = _roundtrip(torch, codec, x)
    load_refine(codec.model, load_checkpoint(best))
    comp1, dec1, _, _ = _roundtrip(torch, codec, x)
    check(comp1["strings"] == comp0["strings"] and comp1["jpeg_buffers"] == comp0["jpeg_buffers"],
          "serving with the refined weights: the compressed bytes changed")
    psnr0 = _psnr(dec0["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    psnr1 = _psnr(dec1["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    load_refine(codec.model, {"params": params})
    comp, dec, _, _ = _roundtrip(torch, codec, x)
    bpp = _nbytes(comp) * 8.0 / (x.shape[1] * x.shape[2])
    psnr = _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    check(bpp == SERVE_F32["bpp"] and psnr == SERVE_F32["psnr"],
          f"serving after the refinement: bpp {bpp!r}, psnr {psnr!r}, not {SERVE_F32}")
    check(_cudnn_flags(torch) == flags, f"the refine phase changed the process-wide flags: "
          f"{flags} -> {_cudnn_flags(torch)}")
    log("refine", f"device-coder f32 serving with the refined weights: strings and JFIF bytes "
        f"identical, psnr {psnr1!r} dB (artifact's refinement {psnr0!r}); the artifact's back: "
        f"bpp {bpp!r}, psnr {psnr!r} dB (bit for bit); flags unchanged {flags}")
    return {"psnr_refined": psnr1, "psnr_artifact": psnr0}


def _jpeg_codec(torch, x, codec) -> dict:
    """(e) JpegCodec against HyresCodec's JPEG layer on the original image."""
    from hyres_tpu_torch.jpeg import JpegCodec, ParsedJpeg, core, tables
    from hyres_tpu_torch.kernels import dct

    jc = JpegCodec(1, device=x.device)
    dct.reset_launches()
    ms_c, bufs = _timed_once(torch, lambda: jc.compress(x))
    k_c = dict(dct.LAUNCHES)
    check(bufs == codec.compress(x)["jpeg_buffers"],
          "JpegCodec.compress differs from HyresCodec's jpeg_buffers")
    dct.reset_launches()
    ms_d, dec = _timed_once(torch, lambda: jc.decompress(bufs))
    k_d = dict(dct.LAUNCHES)
    check(k_c == {"fdct_quant_blocks": 1, "dequant_idct_blocks": 0}
          and k_d == {"fdct_quant_blocks": 0, "dequant_idct_blocks": 1},
          f"JpegCodec launches: compress {k_c}, decompress {k_d}")
    check(torch.equal(dec, codec.decode_jpeg(bufs)), "JpegCodec.decompress differs from "
          "HyresCodec.decode_jpeg")
    _, bpp = jc(x)
    p = ParsedJpeg(bufs[0])
    coef = core.JpegCoefficients(*(torch.from_numpy(c[None]).to(x.device) for c in p.coeffs),
                                 p.height, p.width)
    bits = core.scan_bits(coef).to(torch.float32)  # jpeg_roundtrip's rate, on the file's coefficients
    rate = float((8.0 * torch.ceil(bits / 8.0) + 8.0 * tables.HEADER_BYTES)[0]
                 / (p.height * p.width))
    bits = int(bits[0])
    check(float(bpp) == rate, f"JpegCodec bpp {float(bpp)!r} against the JFIF's "
          f"scan-bit rate {rate!r}")
    log("refine", f"JpegCodec: compress byte-equal to HyresCodec's ({len(bufs[0])} bytes, "
        f"{ms_c:.2f} ms, K1 once), decompress equal to decode_jpeg ({ms_d:.2f} ms, K2 once), "
        f"bpp {float(bpp)!r} = the JFIF's scan-bit rate ({bits} bits)")
    return {"bytes": len(bufs[0]), "compress_ms": ms_c, "decompress_ms": ms_d,
            "bpp": float(bpp), "scan_bits": bits}


def _seeded_npz(np, shapes: dict, path: Path, seed: int, nonneg=()) -> Path:
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, shp in shapes.items():
        scale = math.sqrt(2.0 / math.prod(shp[1:])) if len(shp) > 1 else 0.01
        a = rng.normal(0, scale, shp).astype(np.float32)
        arrays[k] = np.abs(a) if k in nonneg else a
    np.savez(path, **arrays)
    return path


def _perceptual(torch, x, params, batches, ds: Path, codec, dev: str) -> dict:
    """(f) VGGLoss and LPIPS on the card against the CPU, cli.training with
    the VGG term, a recipe step with and without it, CompressionMetrics."""
    import os

    import numpy as np

    from hyres_tpu_torch import train as ttrain
    from hyres_tpu_torch.cli import training as cli_training
    from hyres_tpu_torch.losses import LPIPS, CompressionMetrics, VGG16Features, VGGLoss
    from hyres_tpu_torch.losses.lpips import AlexFeatures
    from hyres_tpu_torch.utils.device import full_float32

    work = ROOT / "smoke_out" / "refine"
    vgg_npz = _seeded_npz(np, {k: tuple(v.shape) for k, v in
                               VGG16Features().state_dict().items()}, work / "vgg16.npz", 7)
    lp_shapes = {f"net.{k}": tuple(v.shape) for k, v in AlexFeatures().state_dict().items()}
    lp_shapes.update({f"lin{i}.weight": (1, c, 1, 1)
                      for i, c in enumerate((64, 192, 384, 256, 256))})
    lp_npz = _seeded_npz(np, lp_shapes, work / "lpips.npz", 8,
                         {f"lin{i}.weight" for i in range(5)})
    a = batches[0][:2, :128, :128]
    b = np.clip(a + 0.05 * np.random.default_rng(4).standard_normal(a.shape), 0, 1)
    b = b.astype(np.float32)
    saved = os.environ.pop("HYRES_VGG16_WEIGHTS", None)
    res, pair = {}, {}
    try:
        os.environ["HYRES_VGG16_WEIGHTS"] = str(vgg_npz)
        for d in (dev, "cpu"):
            vgg = VGGLoss().to(d)
            check(vgg.pretrained, "VGGLoss did not load HYRES_VGG16_WEIGHTS")
            xa = torch.from_numpy(a).to(d).requires_grad_()
            with full_float32():
                v = vgg(xa, torch.from_numpy(b).to(d))
                v.backward()
                lp = LPIPS(str(lp_npz)).to(d)(torch.from_numpy(a).to(d), torch.from_numpy(b).to(d))
            pair[d] = (float(v.detach()), xa.grad.cpu(), float(lp))
        del os.environ["HYRES_VGG16_WEIGHTS"]
        (vc, gc, lc), (vp, gp, lpc) = pair[dev], pair["cpu"]
        # the L1 term's gradient is sign(a - b): where the two activations
        # nearly tie, summation order flips single elements, so the
        # gradient is held in norm and its largest element only printed
        g_max = float((gc - gp).abs().max()) / float(gp.abs().max())
        g_l2 = float(torch.linalg.vector_norm(gc - gp) / torch.linalg.vector_norm(gp))
        check(abs(vc - vp) <= LOSS_RTOL * abs(vp) and abs(lc - lpc) <= LOSS_RTOL * abs(lpc)
              and g_l2 <= VGG_GRAD_L2, f"VGGLoss {vc!r}/{vp!r}, LPIPS {lc!r}/{lpc!r}, "
              f"VGG gradient {g_l2:.3g} in norm (card/CPU)")
        log("refine", f"VGGLoss card/CPU {vc!r}/{vp!r}, gradient into x {g_l2:.3g} in norm "
            f"(largest element {g_max:.3g} of max |g|); LPIPS {lc!r}/{lpc!r} (seeded .npz "
            "weights, 2x128x128)")
        res["card_vs_cpu"] = {"vgg": [vc, vp], "vgg_grad_l2": g_l2, "vgg_grad_max": g_max,
                              "lpips": [lc, lpc]}

        # cli.training with the VGG term on random features, f32 and bf16
        steps = []
        real = ttrain.make_train_step

        def recording(*args, **kw):
            fn = real(*args, **kw)

            def step(*a2, **k2):
                m = fn(*a2, **k2)
                steps.append({k: float(m[k]) for k in ("loss", "vgg_loss", "skipped_nonfinite")})
                return m
            return step

        ttrain.make_train_step = recording
        try:
            for extra in ([], ["--mixed-precision"]):
                steps.clear()
                out = work / ("train_vgg" + "".join(extra).replace("-", "_"))
                cli_training.main(["-d", str(ds), "--device", dev, "-e", "1", "--batch-size",
                                   "2", "--test-batch-size", "2", "--steps-per-epoch", "2",
                                   "--num-workers", "4", "--pretrained", "--checkpoint",
                                   str(ARTIFACT), "--alpha", str(VGG_ALPHA),
                                   "--allow-random-vgg", "--savepath", str(out)] + extra)
                check(len(steps) == 2 and all(math.isfinite(m["loss"]) and m["vgg_loss"] > 0
                                              and m["skipped_nonfinite"] == 0 for m in steps),
                      f"cli.training --alpha {VGG_ALPHA} {extra}: steps {steps}")
                res["cli" + "".join(extra)] = list(steps)
                log("refine", f"cli.training --alpha {VGG_ALPHA} --allow-random-vgg "
                    f"{' '.join(extra) or '(f32)'}: 2 steps, losses "
                    + ", ".join(f"{m['loss']:.3f} (vgg {m['vgg_loss']:.1f})" for m in steps))
        finally:
            ttrain.make_train_step = real
    finally:
        if saved is not None:
            os.environ["HYRES_VGG16_WEIGHTS"] = saved

    # one recipe step (f32) with and without the VGG term, in turns
    vgg = VGGLoss().to(dev)
    runs = {}
    for name, kw in (("alpha 0", {}), (f"alpha {VGG_ALPHA}", {"alpha": VGG_ALPHA, "vgg_fn": vgg})):
        state = _train_state(torch, _recipe_model(torch, params, None, dev))
        runs[name] = ttrain.make_train_step(state, TRAIN_LMBDA, **kw)
    gen = torch.Generator(dev).manual_seed(3)
    xs = [torch.from_numpy(bt).to(dev) for bt in batches]
    times = {k: [] for k in runs}
    peak = {}
    for i in range(2 + 6):
        for k in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            torch.cuda.reset_peak_memory_stats()
            ms, m = _timed_once(torch, lambda: runs[k](xs[i % len(xs)], gen, True))
            peak[k] = max(peak.get(k, 0), torch.cuda.max_memory_allocated())
            check(float(m["skipped_nonfinite"]) == 0 and math.isfinite(float(m["loss"])),
                  f"recipe step {k}: skipped or not finite")
            if i >= 2:
                times[k].append(ms)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log("refine", f"f32 recipe step (B={TRAIN_B}, {TRAIN_P}x{TRAIN_P}) in alternating turns, "
        "median of 6: " + ", ".join(f"{k} {v:.2f} ms (peak {peak[k] / 2**30:.2f} GiB)"
                                    for k, v in med.items())
        + f"; the VGG term costs {med[f'alpha {VGG_ALPHA}'] - med['alpha 0']:.2f} ms a step")
    res["step_ms"] = {"turns": times, "median": med, "peak_bytes": peak}
    del runs, xs
    torch.cuda.empty_cache()

    comp, dec, _, _ = _roundtrip(torch, codec, x)
    metrics = CompressionMetrics(device=x.device).compute_all(dec["x_hat"].float(), x)
    psnr = _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    check(abs(metrics["psnr"] - psnr) <= PSNR_METRIC_ATOL_DB and psnr == SERVE_F32["psnr"],
          f"CompressionMetrics psnr {metrics['psnr']!r} against {psnr!r}")
    log("refine", f"CompressionMetrics on the f32 device-coder roundtrip: {metrics} (the main "
        f"phase's psnr {psnr!r})")
    res["metrics"] = metrics
    return res


def phase_refine(torch, x, codec_f32, smi: str, dev: str = "cuda") -> dict:
    """The rest of the HyRES pipeline at full width (N=128, M=192, q=1):
    (a) refinement steps at the recipe, (b) the card's step against the
    CPU's, (c) the refine CLIs, (d) serving after the refinement changed,
    (e) JpegCodec, (f) perceptual training and CompressionMetrics."""
    import numpy as np

    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    t0 = time.perf_counter()
    _, params, _ = load_artifact(ARTIFACT)
    img = x[0].cpu().numpy()
    images = [img, img[:, ::-1], img[::-1]]
    rng = np.random.default_rng(2027)
    batches = [_crops(np, rng, images, TRAIN_B) for _ in range(4)]
    out = {"steps": _refine_steps(torch, params, batches, smi, dev)}
    out["card_vs_cpu"] = _refine_card_vs_cpu(torch, params, batches[1][:2], dev)
    ds = _refine_dataset(np, images, rng, ROOT / "smoke_out" / "refine" / "dataset")
    out["cli"], best = _refine_clis(torch, x, ds, dev)
    out["serving"] = _refine_serving(torch, x, codec_f32, best, params)
    out["jpeg_codec"] = _jpeg_codec(torch, x, codec_f32)
    out["perceptual"] = _perceptual(torch, x, params, batches, ds, codec_f32, dev)
    out["seconds"] = time.perf_counter() - t0
    log("refine", f"phase done in {out['seconds']:.1f} s")
    return out


# -- baselines -----------------------------------------------------------------

BASELINE_FAMILIES = ("elic", "cheng2020")
# Seeded weights at the published widths: flax's initialisers from
# torch.Generator seed 0, with the entropy models set so that a random
# model's rates fit the device coder's buffers (else its planes overflow
# the escape list and the stream cap and re-code on the host): the scales'
# output bias set to BASELINE_SCALE_BIAS, and the factorized prior fit to
# the model's z of a 256x256 crop of the image on the CPU (its initial
# density costs 5.3 bits a z symbol, over the 4-bit cap of a plane above
# 65,536 symbols), its quantiles then refit in closed form.
BASELINE_SCALE_BIAS = 2.0
BASELINE_PRIOR_STEPS = 100
BASELINE_REPS = 3               # timed roundtrips a codec (median)
BASELINE_TRAIN_STEPS = 4        # the first warms cuDNN's autotuner
BASELINE_BPP_RTOL = 0.005       # the card's f32 roundtrip against the CPU's
BASELINE_PSNR_ATOL_DB = 0.02
BASELINE_SYM_FRAC = 0.001       # of the symbols the card and the CPU may differ in
# The mixture variant ("cheng2020-gmm"): each component's mean channels'
# output bias apart (else a random head makes three equal components) and
# the scales' at GMM_SCALE_BIAS, as the benchmark's cheng2020-attn-gmm3-n192
GMM_MEAN_BIAS = (-1.5, 0.0, 1.5)
GMM_SCALE_BIAS = 1.5
_BASELINE_STATES: dict = {}


def _baseline_new(family: str, compute_dtype=None):
    from hyres_tpu_torch import models

    if family == "elic":
        return models.LightWeightELIC(compute_dtype=compute_dtype)
    if family == "cheng2020-gmm":
        return models.Cheng2020withCheckerboard(compute_dtype=compute_dtype, attention=True,
                                                mixtures=len(GMM_MEAN_BIAS))
    return models.Cheng2020withCheckerboard(compute_dtype=compute_dtype)


def _baseline_state(torch, family: str) -> dict:
    """The family's seeded state dict (computed once a family)."""
    if family in _BASELINE_STATES:
        return _BASELINE_STATES[family]
    from hyres_tpu_torch import models
    from hyres_tpu_torch.entropy import refit_model_quantiles
    from hyres_tpu_torch.nn import init_parameters
    from hyres_tpu_torch.utils.convert import from_flax, to_flax
    from hyres_tpu_torch.utils.png import load_image

    model = _baseline_new(family)
    if family == "elic":
        heads = [(getattr(model, f"param_aggregation_{i}").Conv_2.Conv_0.bias, slice(g, None),
                  BASELINE_SCALE_BIAS) for i, g in enumerate(model.groups)]
    elif family == "cheng2020-gmm":  # K blocks each of logits, means, scales
        bias, K, M = model.entropy_parameters.Conv_2.Conv_0.bias, model.mixtures, model.N
        heads = [(bias, slice((K + k) * M, (K + k + 1) * M), mean)
                 for k, mean in enumerate(GMM_MEAN_BIAS)]
        heads.append((bias, slice(2 * K * M, None), GMM_SCALE_BIAS))
    else:
        heads = [(model.entropy_parameters.Conv_2.Conv_0.bias, slice(0, model.N),
                  BASELINE_SCALE_BIAS)]
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for bias, part, value in heads:
            bias[part] = value
        _, z = model.analysis(torch.from_numpy(load_image(IMAGE)[:, 128:384, 256:512].copy()))
    eb = model.entropy_bottleneck
    opt = torch.optim.Adam([p for n, p in eb.named_parameters() if n != "quantiles"], lr=1e-2)
    gen = torch.Generator().manual_seed(0)
    for _ in range(BASELINE_PRIOR_STEPS):
        loss = -torch.log2(eb(z, noise=True, generator=gen)[1]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    state = from_flax(refit_model_quantiles({"params": to_flax(model)})["params"])
    _BASELINE_STATES[family] = state
    return state


def _baseline_model(torch, family: str, compute_dtype=None):
    model = _baseline_new(family, compute_dtype)
    model.load_state_dict(_baseline_state(torch, family))
    return model


def _baseline_codec(torch, family: str, coder: str, compute_dtype, device: str):
    from hyres_tpu_torch import models

    cls = models.ElicCodec if family == "elic" else models.Cheng2020Codec
    codec = cls(_baseline_model(torch, family, compute_dtype), coder=coder, device=device)
    check(codec.update() and not codec.update(), f"{family}: update() did not bake once")
    return codec


def _baseline_roundtrip(torch, codec, x):
    torch.cuda.synchronize()
    t = time.perf_counter()
    comp = codec.compress(x)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t
    t = time.perf_counter()
    dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
    torch.cuda.synchronize()
    return comp, dec, t_c, time.perf_counter() - t


def _strings_nbytes(obj) -> int:
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    return sum(_strings_nbytes(s) for s in obj)


def _expected_shapes(family: str, comp) -> "Counter":
    """The launches by shape a device-coder roundtrip must make, read from
    its frames' lanes: one K3 over every plane (ELIC: the y planes, then z;
    Cheng2020: z, then the two classes), K4 a y plane, K5 once."""
    from collections import Counter

    y, z = comp["strings"]
    lanes = [1 << (p[0][0] & 0x7F) for p in y] + [1 << (z[0][0] & 0x7F)]
    k3 = tuple(lanes) if family == "elic" else (lanes[-1], *lanes[:-1])
    want = Counter({("encode_planes", k3): 1, ("eb_decode", lanes[-1]): 1})
    for n in lanes[:-1]:
        want["gauss_decode", n] += 1
    return want


def _baseline_paths(torch, family: str, codecs, requests) -> dict:
    """Each coder's path over the requests in f32 and bf16, the launch counts
    set to 0 just before it and read just after."""
    from collections import Counter

    import numpy as np

    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec

    out = {"requests": [], "launches": {}, "shapes": {}}
    for coder in CODERS:
        krans.reset_launches()
        tcodec.reset_wire_stats()
        want, n_rt = Counter(), 0
        for (c, name), codec in codecs.items():
            if c != coder:
                continue
            for req, xr in requests.items():
                comp, dec, t_c, t_d = _baseline_roundtrip(torch, codec, xr)
                n_rt += 1
                for a, b in zip(comp["symbols"], dec["symbols"]):
                    check(np.array_equal(_np(a), _np(b)),
                          f"{family} {coder}/{name}/{req}: decoded symbols differ")
                x_hat = dec["x_hat"].float().cpu().numpy()
                check(x_hat.shape == tuple(xr.shape) and np.isfinite(x_hat).all(),
                      f"{family} {coder}/{name}/{req}: bad reconstruction {x_hat.shape}")
                bpp = _strings_nbytes(comp["strings"]) * 8.0 / (xr.shape[1] * xr.shape[2])
                psnr = _psnr(x_hat, xr.cpu().numpy())
                if coder == "device":
                    want += _expected_shapes(family, comp)
                out["requests"].append({"coder": coder, "precision": name, "request": req,
                                        "bpp": bpp, "psnr": psnr})
                log("baselines", f"{family} {coder} {name} {req}: bpp {bpp!r}, psnr {psnr!r} "
                    "dB, symbols exact")
        launches, shapes = dict(krans.LAUNCHES), Counter(krans.LAUNCH_SHAPES)
        fb = tcodec.WIRE_STATS["host_fallbacks"]
        out["launches"][coder] = launches
        out["shapes"][coder] = {f"{k[0]} {k[1]}": v for k, v in shapes.items()}
        if coder == "device":
            check(fb == 0, f"{family}: the device coder re-framed with the host coder: "
                  f"{tcodec.WIRE_STATS['fallback_reasons']}")
            check(shapes == want, f"{family} device path: launches by shape {dict(shapes)}, "
                  f"not {dict(want)}")
            per = len(codecs[("device", "f32")].model.groups) * 2 if family == "elic" else 2
            check(launches == {"encode_planes": n_rt, "gauss_decode": per * n_rt,
                               "eb_decode": n_rt, "gmm_rows": 0, "gmm_decode": 0},
                  f"{family} device path: {n_rt} roundtrips launched {launches}")
        else:
            check(not any(launches.values()), f"{family} host path launched {launches}")
        log("baselines", f"{family} {coder} coder: {n_rt} roundtrips launched {launches}, by "
            f"shape {out['shapes'][coder]}, host fallbacks {fb}")
    return out


def _baseline_syncs(torch, family: str, codecs, x) -> dict:
    """The dispatch halves under sync-debug "error", then the synchronising
    calls of a full device-coder request, and the median walls."""
    from hyres_tpu_torch.utils.device import wait_event

    out = {"syncs": {}, "walls": {}}
    for (coder, name), codec in codecs.items():
        label = f"{coder} {name}"
        if coder == "device":
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
            s_c, comp = _syncs(torch, lambda: codec.compress(x))
            s_d, _ = _syncs(torch, lambda: codec.decompress(comp["strings"], comp["shape"],
                                                            comp["size"]))
            out["syncs"][label] = {"compress": s_c, "decompress": s_d}
            check(not s_c and not s_d, f"{family} {label}: a request synchronises: "
                  f"compress {s_c}, decompress {s_d}")
        walls = [_baseline_roundtrip(torch, codec, x)[2:] for _ in range(BASELINE_REPS)]
        c_ms = sorted(w[0] * 1e3 for w in walls)[BASELINE_REPS // 2]
        d_ms = sorted(w[1] * 1e3 for w in walls)[BASELINE_REPS // 2]
        out["walls"][label] = {"compress_ms": c_ms, "decompress_ms": d_ms,
                               "turns_ms": [[w[0] * 1e3, w[1] * 1e3] for w in walls]}
        log("baselines", f"{family} {label} 768x512: compress {c_ms:.2f} ms, decompress "
            f"{d_ms:.2f} ms (median of {BASELINE_REPS})"
            + (f"; dispatch halves under sync-debug \"error\": no sync; a request's "
               f"synchronising calls: compress {len(s_c)}, decompress {len(s_d)}"
               if coder == "device" else ""))
    return out


def _baseline_stream(torch, family: str, codec, requests) -> dict:
    """inference_stream at depth 2 equal to sequential inference, with its
    launch counts."""
    from collections import Counter

    from hyres_tpu_torch.kernels import rans as krans

    xs = list(requests.values())
    seq = [codec.inference(xr) for xr in xs]
    krans.reset_launches()
    outs = codec.inference_stream(xs, depth=2)
    torch.cuda.synchronize()
    shapes = Counter(krans.LAUNCH_SHAPES)
    want = Counter()
    for a, b in zip(seq, outs):
        check(b["strings"] == a["strings"], f"{family} stream: bytes differ from sequential")
        check(torch.equal(b["x_hat"], a["x_hat"]), f"{family} stream: x_hat differs")
        want += _expected_shapes(family, b)
    check(shapes == want, f"{family} stream: launches by shape {dict(shapes)}, not {dict(want)}")
    log("baselines", f"{family} inference_stream depth 2 over {len(xs)} requests equal to "
        f"sequential inference (bytes, x_hat); launches {dict(krans.LAUNCHES)}")
    return {"launches": dict(krans.LAUNCHES)}


def _baseline_profile(torch, family: str, codecs, x) -> dict:
    """One traced device-coder compress and decompress a precision: wall,
    device busy, the top aten operations and K3-K5's device time."""
    out = {}
    for (coder, name), codec in codecs.items():
        if coder != "device":
            continue
        comp = codec.compress(x)
        for step, fn in (("compress", lambda: codec.compress(x)),
                         ("decompress", lambda: codec.decompress(
                             comp["strings"], comp["shape"], comp["size"]))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prof, _ = _profile(torch, fn)
            wall = (time.perf_counter() - t) * 1e3
            busy = sum(_dev_us(e) for e in prof.events() if e.device_type.name == "CUDA") / 1e3
            avgs = prof.key_averages()
            by_op = sorted(((_dev_us(a, "self_device_time_total"), a.key) for a in avgs
                            if a.key.startswith("aten::")), reverse=True)[:4]
            coder_us = sum(_dev_us(a, "self_device_time_total") for a in avgs
                           if "encode_kernel" in a.key or "decode_warp_kernel" in a.key)
            out[f"{name} {step}"] = {"wall_ms": wall, "device_busy_ms": busy,
                                     "coder_kernels_ms": coder_us / 1e3,
                                     "top_ops": [[k, us / 1e3] for us, k in by_op]}
            log("baselines", f"{family} device {name} {step} (traced): wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.2f}, K3-K5 "
                f"{coder_us / 1e3:.3f} ms; top: "
                + ", ".join(f"{k} {us / 1e3:.2f} ms" for us, k in by_op))
    return out


def _baseline_planes(torch, codec, x):
    """[(kind, encode job, (1, n) int32 table rows)] of one request, in K3's
    order."""
    from hyres_tpu_torch.jpeg.core import pad_to_multiple

    dc = codec.device_coder
    with torch.inference_mode():
        z_sym, planes = codec.latents(pad_to_multiple(x, 64))
    jobs = codec.device_jobs(z_sym, planes)
    rows = codec._in_k3_order(dc._z_idx(z_sym.shape, z_sym.device), [i for _, i in planes])
    kinds = codec._in_k3_order("eb", ["gauss"] * len(planes))
    return [(k, j, r.reshape(1, -1).to(torch.int32).contiguous())
            for k, j, r in zip(kinds, jobs, rows)]


def _baseline_kernels(torch, family: str, codec, requests) -> dict:
    """K3 over every plane of a request, and K4 at each lane tier and K5 on
    their frames, against the plain versions on CPU copies of the same
    inputs (streams, states, word counts, escape lists and symbols equal);
    each timed beside its bound."""
    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.kernels import rans as krans

    def cpu(p):
        return p._replace(**{f: getattr(p, f).cpu() for f in ("start", "freq", "low", "ks")})

    out, timed = {}, set()
    dc = codec.device_coder
    for req in ("original", "crop256"):
        planes = _baseline_planes(torch, codec, requests[req])
        kp = [j.plane for _, j, _ in planes]
        got = krans.encode_planes(kp)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = krans.encode_planes_ref([cpu(p) for p in kp])
        p3_ms = (time.perf_counter() - t) * 1e3
        for (kind, job, _), g, w in zip(planes, got, want):
            for a, b in zip(g, w):
                check(torch.equal(a.cpu(), b), f"{family} {req} K3 ({kind}, {job.lanes} "
                      "lanes): differs from the plain version")
        lanes = [j.lanes for _, j, _ in planes]
        n3 = sum(p.start.numel() for p in kp)
        nbytes3 = (16 * n3 + sum(2 * int(g[2].sum()) + 4 * g[1].numel() + 4 * g[2].numel()
                                 for g in got))
        b3 = _bound_ms(nbytes3, n3, OPS_PER_SYMBOL["K3"])
        k3_ms = _stream_ms(torch, lambda: krans.encode_planes(kp))
        T3 = max(p.start.shape[1] for p in kp)
        out[f"K3 {req}"] = {"planes": len(kp), "lanes": lanes, "ms": k3_ms, "plain_ms": p3_ms,
                            "max_abs_err": 0, "bound_ms": b3[0], "bound_by": b3[1],
                            "T": T3, "symbols": n3,
                            "words": [int(g[2][0]) for g in got],
                            "caps": [p.cap for p in kp]}
        log("baselines", f"{family} {req}: K3 over {len(kp)} planes of lanes {lanes} in one "
            f"launch, exact against the plain version; device ms {k3_ms:.4f} (T max {T3}), "
            f"plain {p3_ms:.1f} ms on the CPU; bound {b3[0] * 1e3:.3f} us ({b3[1]}); words "
            f"of cap {[f'{w}/{c}' for w, c in zip(out[f'K3 {req}']['words'], out[f'K3 {req}']['caps'])]}")
        for (kind, job, rows), g in zip(planes, got):
            key = ("K4" if kind == "gauss" else "K5", job.lanes)
            if key in timed:
                continue
            timed.add(key)
            stream, states, n_renorm = g
            esc_pos, esc_val, _ = dr.escape_lists(job.sym, job.esc)
            n = rows.shape[1]
            T = -(-n // job.lanes)
            tab = dc.gauss if kind == "gauss" else dc.eb
            aux = tab.params if kind == "gauss" else tab.offset
            kern = krans.gauss_decode if kind == "gauss" else krans.eb_decode
            plain = krans.gauss_decode_ref if kind == "gauss" else krans.eb_decode_ref
            S = max(1, int(n_renorm[0]))
            args = [dr.to_tl(rows, T, job.lanes, 0), tab.bounds, aux,
                    stream[:, :S].contiguous(), states, esc_pos, esc_val]
            g4 = kern(*args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            w4 = plain(*[a.cpu() for a in args])
            p_ms = (time.perf_counter() - t) * 1e3
            check(torch.equal(g4.cpu(), w4), f"{family} {key}: differs from the plain version")
            check(torch.equal(w4[:, :n], job.sym[:, :n].cpu()),
                  f"{family} {key}: decoded symbols differ from the coded ones")
            k_ms = _stream_ms(torch, lambda: kern(*args))
            nbytes = (8 * args[0].numel() + 2 * S + 4 * job.lanes + 8 * dr.ESC_MAX
                      + 4 * tab.bounds.numel() + 4 * aux.numel())
            b = _bound_ms(nbytes, args[0].numel(), OPS_PER_SYMBOL[key[0]])
            out[f"{key[0]} {key[1]} lanes"] = {
                "request": req, "ms": k_ms, "plain_ms": p_ms, "max_abs_err": 0,
                "bound_ms": b[0], "bound_by": b[1], "T": T, "symbols": args[0].numel(),
                "ms_per_step": k_ms / T}
            log("baselines", f"{family} {key[0]} at {key[1]} lanes ({req}, T {T}): exact "
                f"against the plain version; device ms {k_ms:.4f} ({k_ms / T * 1e3:.4f} us a "
                f"step), plain {p_ms:.1f} ms on the CPU; bound {b[0] * 1e3:.3f} us ({b[1]})")
    return out


def _baseline_gmm(torch, x) -> dict:
    """The mixture variant on the device coder in f32: the image and its
    flip with the launch counts set to 0 just before and read just after,
    then K6 and the mixture decode on the inputs that path gave them,
    against the plain versions on CPU copies, each timed beside its bytes
    bound (K6's integer work is not counted)."""
    import numpy as np

    from hyres_tpu_torch.coding import device_rans as dr
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec

    codec = _baseline_codec(torch, "cheng2020-gmm", "device", None, "cuda")
    requests = {"original": x, "hflip": x.flip(2).contiguous()}
    _baseline_roundtrip(torch, codec, x)  # warm-up: cuDNN's autotuner, the wire's marks
    inputs = {"gmm_rows": [], "gmm_decode": []}
    wrapped = {k: getattr(krans, k) for k in inputs}

    def recorder(k):
        def call(*args):
            inputs[k].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return wrapped[k](*args)
        return call

    out = {"requests": []}
    krans.reset_launches()
    tcodec.reset_wire_stats()
    for k in inputs:
        setattr(krans, k, recorder(k))
    try:
        for req, xr in requests.items():
            comp, dec, t_c, t_d = _baseline_roundtrip(torch, codec, xr)
            for a, b in zip(comp["symbols"], dec["symbols"]):
                check(np.array_equal(_np(a), _np(b)),
                      f"cheng2020-gmm {req}: decoded symbols differ")
            x_hat = dec["x_hat"].float().cpu().numpy()
            check(x_hat.shape == tuple(xr.shape) and np.isfinite(x_hat).all(),
                  f"cheng2020-gmm {req}: bad reconstruction {x_hat.shape}")
            bpp = _strings_nbytes(comp["strings"]) * 8.0 / (xr.shape[1] * xr.shape[2])
            out["requests"].append({"request": req, "bpp": bpp,
                                    "psnr": _psnr(x_hat, xr.cpu().numpy()),
                                    "compress_ms": t_c * 1e3, "decompress_ms": t_d * 1e3})
    finally:
        for k, f in wrapped.items():
            setattr(krans, k, f)
    n = len(requests)
    launches = dict(krans.LAUNCHES)
    check(tcodec.WIRE_STATS["host_fallbacks"] == 0,
          f"cheng2020-gmm: the device coder re-framed: {tcodec.WIRE_STATS['fallback_reasons']}")
    check(launches == {"encode_planes": n, "gauss_decode": 0, "eb_decode": n,
                       "gmm_rows": 4 * n, "gmm_decode": 2 * n},
          f"cheng2020-gmm: {n} roundtrips launched {launches}")
    out["launches"] = {k: v // n for k, v in launches.items()}
    log("baselines", f"cheng2020-gmm device f32: {out['requests']}; symbols exact, no "
        f"fallback; launches a roundtrip {out['launches']}")

    def cpu(args):
        return [a.cpu() if torch.is_tensor(a) else a for a in args]

    for i, args in enumerate(inputs["gmm_rows"][:4]):  # the first request's four planes
        params, K, padded = args[:3]
        got = krans.gmm_rows(params, K, padded)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = krans.gmm_rows_ref(*cpu((params, K, padded)))
        p_ms = (time.perf_counter() - t) * 1e3
        for g, w in zip(got, want):
            check(torch.equal(g.cpu(), w), f"cheng2020-gmm K6 call {i}: differs from the plain "
                  "version")
        if i == 0:
            k_ms, src = _device_ms(torch, lambda: krans.gmm_rows(params, K, padded))
            B = params.shape[0]
            nbytes = 4 * params.numel() + B * padded * (4 + 2 * krans.GMM_SEGMENTS)
            b = _bound_ms(nbytes, params.numel(), 0)
            out["K6"] = {"ms": k_ms, "source": src, "plain_ms": p_ms, "max_abs_err": 0,
                         "bound_ms": b[0], "bound_by": b[1], "rows": B * padded}
    log("baselines", f"cheng2020-gmm K6 on the path's 4 planes ({out['K6']['rows']} rows a "
        f"plane): exact against the plain version; device ms {out['K6']['ms']:.5f} "
        f"({out['K6']['source']}), plain {out['K6']['plain_ms']:.1f} ms on the CPU; bound "
        f"{out['K6']['bound_ms'] * 1e3:.3f} us (bytes)")
    for i, args in enumerate(inputs["gmm_decode"][:2]):  # the first request's two planes
        got = krans.gmm_decode(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = krans.gmm_decode_ref(*cpu(args))
        p_ms = (time.perf_counter() - t) * 1e3
        check(torch.equal(got.cpu(), want), f"cheng2020-gmm mixture decode call {i}: differs "
              "from the plain version")
        if i == 0:
            heads, rows, stream, states = args[:4]
            B, T, lanes = heads.shape
            k_ms, src = _device_ms(torch, lambda: krans.gmm_decode(*args))
            nbytes = (heads.numel() * (4 + 2 * krans.GMM_SEGMENTS) + 2 * stream.numel()
                      + 4 * states.numel() + 8 * dr.ESC_MAX * B + 4 * heads.numel())
            b = _bound_ms(nbytes, heads.numel(), OPS_PER_SYMBOL["K4"])
            out["K6 decode"] = {"ms": k_ms, "source": src, "plain_ms": p_ms, "max_abs_err": 0,
                                "bound_ms": b[0], "bound_by": b[1], "T": T, "lanes": lanes,
                                "ms_per_step": k_ms / T}
    t = out["K6 decode"]
    log("baselines", f"cheng2020-gmm mixture decode on the path's 2 planes (T {t['T']}, "
        f"{t['lanes']} lanes): exact against the plain version; device ms {t['ms']:.5f} "
        f"({t['ms_per_step'] * 1e3:.4f} us a step, {t['source']}), plain {t['plain_ms']:.1f} "
        f"ms on the CPU; bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    del codec
    torch.cuda.empty_cache()
    return out


def _gmm_kernel_lines(gmm: dict) -> list:
    """The kernels' JSON entries of K6 and the mixture decode (no TPU
    kernel codes a mixture)."""
    return [{"name": name, "route": "cuda", "source": "hyres_tpu_torch/kernels/csrc/rans.cu",
             "replaces": None, "launches": gmm["launches"][name], "max_abs_err": 0,
             "ms": gmm[k]["ms"], "plain_ms": gmm[k]["plain_ms"], "bound_ms": gmm[k]["bound_ms"],
             "bound_by": gmm[k]["bound_by"], "library_ms": None}
            for k, name in (("K6", "gmm_rows"), ("K6 decode", "gmm_decode"))]


def _baseline_cpu(torch, family: str, codec, x) -> dict:
    """The f32 device-coder roundtrip of ``x`` on the card against the same
    weights on the CPU (the plain K3-K5)."""
    import numpy as np

    from hyres_tpu_torch.kernels import rans as krans

    res = {}
    for dev in ("cpu", "cuda"):
        c = codec if dev == "cuda" else _baseline_codec(torch, family, "device", None, "cpu")
        before = dict(krans.LAUNCHES)
        comp = c.compress(x.to(dev))
        dec = c.decompress(comp["strings"], comp["shape"], comp["size"])
        if dev == "cpu":
            check(krans.LAUNCHES == before, f"{family}: the CPU run launched a kernel")
        syms = [_np(s) for s in comp["symbols"]]
        for a, b in zip(syms, dec["symbols"]):
            check(np.array_equal(a, _np(b)), f"{family} {dev}: decoded symbols differ")
        bpp = _strings_nbytes(comp["strings"]) * 8.0 / (x.shape[1] * x.shape[2])
        res[dev] = (bpp, _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy()), syms)
    (bpp_c, psnr_c, sym_c), (bpp_g, psnr_g, sym_g) = res["cpu"], res["cuda"]
    diff = sum(int((a != b).sum()) for a, b in zip(sym_c, sym_g))
    total = sum(a.size for a in sym_c)
    check(diff <= BASELINE_SYM_FRAC * total, f"{family}: {diff} of {total} symbols differ "
          "between the card and the CPU")
    check(abs(bpp_g - bpp_c) <= BASELINE_BPP_RTOL * bpp_c
          and abs(psnr_g - psnr_c) <= BASELINE_PSNR_ATOL_DB,
          f"{family}: card bpp/psnr {bpp_g}/{psnr_g} against the CPU's {bpp_c}/{psnr_c}")
    log("baselines", f"{family} f32 device coder, card against CPU on a 256x256 crop: "
        f"{diff} of {total} symbols differ; bpp {bpp_g!r} / {bpp_c!r}, psnr {psnr_g!r} / "
        f"{psnr_c!r} dB")
    return {"symbols_differ": diff, "symbols": total, "bpp": [bpp_g, bpp_c],
            "psnr": [psnr_g, psnr_c]}


def _baseline_train(torch, family: str, images, smi: str) -> dict:
    """Steps at the recipe (16 x 256x256, f32, noise mode) on one batch:
    finite, none skipped, the loss falling; ms a step and peak memory."""
    import numpy as np

    from hyres_tpu_torch.train import make_train_step

    model = _baseline_model(torch, family).cuda()
    state = _train_state(torch, model)
    step = make_train_step(state, TRAIN_LMBDA)
    batch = torch.from_numpy(_crops(np, np.random.default_rng(7), images, TRAIN_B)).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    flags = _cudnn_flags(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, mets = [], []
    for _ in range(BASELINE_TRAIN_STEPS):
        ms, m = _timed_once(torch, lambda: step(batch, gen, True))
        times.append(ms)
        mets.append({k: float(m[k]) for k in ("loss", "bpp_loss", "mse_loss",
                                             "skipped_nonfinite")})
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in mets]
    check(all(m["skipped_nonfinite"] == 0 and math.isfinite(m["loss"]) for m in mets),
          f"{family} train: a step was skipped or not finite: {mets}")
    check(losses[-1] < losses[0], f"{family} train: the loss did not fall: {losses}")
    check(_cudnn_flags(torch) == flags, f"{family} train: the process-wide flags changed")
    srt = sorted(times[1:])
    log("baselines", f"{family} train step at B={TRAIN_B}, {TRAIN_P}x{TRAIN_P}, f32: median "
        f"{srt[len(srt) // 2]:.2f} ms of {len(srt)} after a warm-up ({smi}); peak memory "
        f"{peak / 2**30:.2f} GiB; losses {[round(v, 4) for v in losses]}")
    del state, step, model, batch
    torch.cuda.empty_cache()
    return {"step_ms": times, "median_ms": srt[len(srt) // 2], "peak_bytes": peak,
            "metrics": mets}


def _baseline_clis(torch, family: str, x) -> dict:
    """cli.updata on the seeded weights, cli.codec encode/decode (device
    coder) to a PNG byte-equal to the in-process decode, cli.inference
    giving the in-process bpp, and cli.training for an epoch."""
    import csv
    import types

    import numpy as np

    from hyres_tpu_torch.cli import codec as cli_codec
    from hyres_tpu_torch.cli import inference as cli_inference
    from hyres_tpu_torch.cli import training as cli_training
    from hyres_tpu_torch.cli import updata as cli_updata
    from hyres_tpu_torch.train import load_checkpoint, save_checkpoint
    from hyres_tpu_torch.utils.convert import to_flax
    from hyres_tpu_torch.utils.png import save_image, write_png

    work = ROOT / "smoke_out" / "baselines" / family
    for d in ("img", "hyc", "png", "want", "ds/train", "ds/test"):
        (work / d).mkdir(parents=True, exist_ok=True)
    model = _baseline_model(torch, family)
    save_checkpoint({"epoch": np.int64(0), "params": {"params": to_flax(model)}},
                    work / "raw.msgpack")
    cli_updata.main(["--filepath", str(work / "raw.msgpack"), "--name", family, "--dir",
                     str(work), "--N", str(model.N), "--M", str(model.M)])
    art = ["--checkpoint", str(work / f"{family}.msgpack")]
    save_image(x, work / "img" / "original.png")
    cli_codec.main(["encode", *art, "--model", family, "--coder", "device",
                    str(work / "img" / "original.png"), "-o", str(work / "hyc")])
    cli_codec.main(["decode", *art, str(work / "hyc" / "original.hyc"), "-o", str(work / "png")])
    args = types.SimpleNamespace(checkpoint=art[1], model=family, N=128, M=192,
                                 jpeg_quality=1, coder="device", refit_quantiles=True)
    codec = cli_inference.load_codec(args, torch.device("cuda"))[1]
    comp = codec.compress(x)
    dec = codec.decompress(comp["strings"], comp["shape"], comp["size"])
    save_image(torch.clamp(dec["x_hat"], 0, 1), work / "want" / "original.png")
    check((work / "png" / "original.png").read_bytes()
          == (work / "want" / "original.png").read_bytes(),
          f"{family} cli.codec: the PNG differs from the in-process decode")
    cli_inference.main([*art, "--model", family, "--coder", "device", "--input",
                        str(work / "img"), "--output", str(work / "inf")])
    with open(work / "inf" / "metrics.csv") as f:
        row = next(csv.DictReader(f))
    bpp = _strings_nbytes(comp["strings"]) * 8.0 / (x.shape[1] * x.shape[2])
    check(abs(float(row["total_bpp"]) - bpp) <= 1e-9 * bpp,
          f"{family} cli.inference: bpp {row['total_bpp']} against in-process {bpp}")
    base = (x[0].cpu().numpy() * 255.0 + 0.5).astype(np.uint8)
    for i, v in enumerate([base, base[:, ::-1], base[::-1], base[::-1, ::-1]]):
        write_png(work / "ds" / ("train" if i < 3 else "test") / f"{i}.png",
                  np.ascontiguousarray(v[:256, :256]))
    t = time.perf_counter()
    cli_training.main(["-d", str(work / "ds"), "--model", family, "-e", "1", "--batch-size",
                       "2", "--test-batch-size", "1", "--num-workers", "2", "--savepath",
                       str(work / "ck")])
    train_s = time.perf_counter() - t
    raw = load_checkpoint(work / "ck" / "checkpoint_last_0.msgpack")
    check(int(raw["step"]) == 1, f"{family} cli.training: {int(raw['step'])} steps, not 1")
    log("baselines", f"{family} CLIs: updata -> codec encode/decode (device coder) PNG equal "
        f"to the in-process decode; inference bpp {row['total_bpp']} equal to in-process; "
        f"training 1 epoch in {train_s:.1f} s")
    return {"hyc_bytes": (work / "hyc" / "original.hyc").stat().st_size,
            "inference_row": row, "train_s": train_s}


def phase_baselines(torch, x, smi: str) -> dict:
    """The ELIC and Cheng2020 families at full width on seeded weights."""
    t0 = time.perf_counter()
    requests = {"original": x, "hflip": x.flip(2).contiguous(),
                "crop256": x[:, 128:384, 256:512].contiguous()}
    img = x[0].cpu().numpy()
    images = [img, img[:, ::-1], img[::-1]]
    out = {}
    for family in BASELINE_FAMILIES:
        codecs = {(coder, name): _baseline_codec(torch, family, coder, dt, "cuda")
                  for coder in CODERS for name, dt in (("f32", None), ("bf16", torch.bfloat16))}
        for codec in codecs.values():  # warm-up: one roundtrip a shape
            for req in ("original", "crop256"):
                _baseline_roundtrip(torch, codec, requests[req])
        fam = out[family] = _baseline_paths(torch, family, codecs, requests)
        fam["wire"] = {
            name: _wire(torch, codecs[("device", name)],
                        lambda xr, c=codecs[("device", name)]: _baseline_roundtrip(torch, c, xr),
                        [x, requests["hflip"], x], f"{family} device {name}", "baselines")
            for name in ("f32", "bf16")}
        fam.update(_baseline_syncs(torch, family, codecs, x))
        fam["stream"] = _baseline_stream(torch, family, codecs[("device", "f32")], requests)
        fam["profile"] = _baseline_profile(torch, family, codecs, x)
        fam["kernels"] = _baseline_kernels(torch, family, codecs[("device", "f32")], requests)
        fam["cpu"] = _baseline_cpu(torch, family, codecs[("device", "f32")],
                                   requests["crop256"])
        del codecs
        torch.cuda.empty_cache()
        fam["train"] = _baseline_train(torch, family, images, smi)
        fam["cli"] = _baseline_clis(torch, family, x)
    out["cheng2020-gmm"] = _baseline_gmm(torch, x)
    out["seconds"] = time.perf_counter() - t0
    log("baselines", f"phase done in {out['seconds']:.1f} s")
    return out


# -- TCM (K7) -----------------------------------------------------------------

# (H, W, C, head width, window) of K7's calls on a 768x512 request: g_a's
# three stages (g_s's mirrored), SWAtten on y, h_a / h_s
TCM_SHAPES = [(384, 256, 128, 8, 8), (192, 128, 128, 16, 8), (96, 64, 128, 32, 8),
              (48, 32, 128, 16, 8), (24, 16, 128, 32, 4)]
K7_ATOL = 2e-5                  # tests/test_torch_cuda.py: float32 sums of 64 products
TCM_LAUNCHES = (32, 30)         # K7 launches a compress, a decompress (PERF.md §6)


def _k7_bound_ms(H: int, W: int, C: int, d: int, p: int) -> tuple[float, str]:
    """Least time of one call: qkv read once, the output written once, the
    bias table once (float32); QK^T and PV at the FP32 peak."""
    tokens = H * W
    t_bytes = 4 * (4 * tokens * C + (C // d) * p ** 4) / PEAK_BYTES_S
    t_ops = 4.0 * tokens * p * p * C / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _k7_shapes(torch) -> dict:
    """K7 at each shape, W and SW, against its plain version in float64 on
    CPU copies; device time beside the bound and the plain version on the
    card."""
    from hyres_tpu_torch.kernels import window_attn as k7

    g = torch.Generator().manual_seed(7)
    rows = []
    for H, W, C, d, p in TCM_SHAPES:
        heads = C // d
        qkv = torch.randn((1, H, W, 3 * C), generator=g) * 2.0
        bias = k7.relative_bias(torch.randn((heads, 2 * p - 1, 2 * p - 1), generator=g), p)
        qkv_c, bias_c = qkv.cuda(), bias.cuda()
        bound, by = _k7_bound_ms(H, W, C, d, p)
        for shifted in (False, True):
            got = k7.window_attention(qkv_c, bias_c, heads, p, shifted)
            want = k7.window_attention_ref(qkv.double(), bias.double(), heads, p, shifted)
            err = float((got.cpu().double() - want).abs().max())
            kind = "SW" if shifted else "W"
            check(err <= K7_ATOL, f"tcm: K7 at {H}x{W}, C {C}, d {d}, p {p}, {kind}: max abs "
                  f"err {err:.3g} against the float64 plain version (bar {K7_ATOL})")
            ms, src = _device_ms(torch, lambda: k7.window_attention(qkv_c, bias_c, heads, p,
                                                                     shifted))
            plain_ms = _event_ms(torch, lambda: k7.window_attention_ref(qkv_c, bias_c, heads, p,
                                                                         shifted), 5, 1)
            rows.append({"H": H, "W": W, "C": C, "d": d, "p": p, "shifted": shifted,
                         "max_abs_err": err, "ms": ms, "source": src, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by})
            log("tcm", f"K7 {H}x{W}, C {C}, d {d}, p {p}, {kind}: max abs err {err:.3g}; "
                f"{ms:.4f} ms ({src}) against a {bound:.4f} ms bound ({by}, "
                f"{100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
    return {"shapes": rows}


def _tcm_codec(torch):
    """TCM at its published widths (N=128, M=320) on the device coder,
    seeded as the card tests seed it: the blocks' joining convolutions at
    0.1, the scale stacks' output bias at 3."""
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
    check(codec.update() and not codec.update(), "tcm: update() did not bake once")
    return codec


def phase_tcm(torch, x) -> dict:
    """K7 at TCM's attention shapes, then TCM's roundtrips with their K7
    launches: op by op, capturing the dispatch graph, replaying it."""
    from hyres_tpu_torch.kernels import window_attn as k7
    from hyres_tpu_torch.models import codec as tcodec

    t0 = time.perf_counter()
    out = _k7_shapes(torch)
    codec = _tcm_codec(torch)
    xr = x[:, :512, :768].contiguous()
    tcodec.reset_wire_stats()
    k7.WINDOW_ATTN_STATS.update(dict.fromkeys(k7.WINDOW_ATTN_STATS, 0))
    reads, walls = [], []
    for turn in ("op by op", "capturing", "replaying"):
        before = k7.WINDOW_ATTN_STATS["launches"]
        replays = tcodec.WIRE_STATS["graph_replays"]
        t_c, comp = _timed_once(torch, lambda: codec.compress(xr))
        mid = k7.WINDOW_ATTN_STATS["launches"]
        t_d, dec = _timed_once(torch, lambda: codec.decompress(comp["strings"], comp["shape"],
                                                               comp["size"]))
        reads.append((mid - before, k7.WINDOW_ATTN_STATS["launches"] - mid))
        walls.append((t_c, t_d))
        for a, b in zip(comp["symbols"], dec["symbols"]):
            check(torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()),
                  f"tcm {turn}: decoded symbols differ from the coded")
        check(tuple(dec["x_hat"].shape) == tuple(xr.shape),
              f"tcm {turn}: bad reconstruction {tuple(dec['x_hat'].shape)}")
        log("tcm", f"roundtrip {turn} (graph replays {replays} -> "
            f"{tcodec.WIRE_STATS['graph_replays']}): K7 launches {reads[-1]}, compress "
            f"{t_c:.2f} ms, decompress {t_d:.2f} ms; symbols exact")
    w = tcodec.WIRE_STATS
    check(w["graph_replays"] >= 1 and w["host_fallbacks"] == 0,
          f"tcm: replays {w['graph_replays']}, host fallbacks {w['host_fallbacks']} "
          f"({w['fallback_reasons']})")
    check(reads == [TCM_LAUNCHES] * 3, f"tcm: K7 launches a compress, a decompress {reads}, "
          f"not {TCM_LAUNCHES} each time")
    del codec
    torch.cuda.empty_cache()
    out.update(launches=reads, walls_ms=walls, stats=dict(k7.WINDOW_ATTN_STATS),
               seconds=time.perf_counter() - t0)
    log("tcm", f"K7 counters over the three roundtrips {out['stats']}; phase "
        f"{out['seconds']:.1f} s")
    return out


def _tcm_kernel_lines(tcm: dict) -> list:
    """K7's row of the kernels line: its g_a stage-1 W block, the worst
    error over every shape, launches a TCM roundtrip."""
    first = tcm["shapes"][0]
    return [{"name": "window_attention", "route": "cuda",
             "source": "hyres_tpu_torch/kernels/csrc/window_attn.cu", "replaces": None,
             "launches": sum(tcm["launches"][-1]),
             "max_abs_err": max(r["max_abs_err"] for r in tcm["shapes"]),
             "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
             "bound_by": first["bound_by"], "library_ms": None}]


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


# -- convert ---------------------------------------------------------------------

CONVERT_BPP_RTOL = 0.005         # against the artifact's baked tables
CONVERT_PSNR_ATOL_DB = 0.02
# what a reference checkpoint carries beside the weights, which the import drops
REFERENCE_EXTRAS = ("se_block.fc.0.weight",
                    "residual_model.entropy_bottleneck._quantized_cdf",
                    "residual_model.entropy_bottleneck._offset",
                    "residual_model.entropy_bottleneck._cdf_length",
                    "residual_model.gaussian_conditional._quantized_cdf",
                    "residual_model.gaussian_conditional._offset",
                    "residual_model.gaussian_conditional._cdf_length",
                    "residual_model.gaussian_conditional.scale_table")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _reference_pth(torch, np, params, path: Path) -> int:
    """The artifact's weights as a reference training checkpoint
    (CompressAI names, with the entries the import must drop)."""
    from hyres_tpu_torch.utils import torch_convert as tc

    sd = {k: torch.from_numpy(np.array(v)) for k, v in tc.export_hyres(params).items()}
    for i, k in enumerate(REFERENCE_EXTRAS):
        sd[k] = (torch.zeros(4, 64) if k.startswith("se_block")
                 else torch.arange(8 + i, dtype=torch.float32 if "scale" in k else torch.int32))
    torch.save({"epoch": 3, "state_dict": sd,
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0]}]}},
               path)
    return path.stat().st_size


def phase_convert(torch, x, codec_tables, dev: str = "cuda") -> dict:
    """A reference ``.pth`` of the artifact's weights imported
    (``utils/torch_convert.py``) and served with the device coder: the same
    bytes as the artifact's params with the same fresh ``update()``, and
    the artifact's baked tables' rate and quality within the bars."""
    import numpy as np

    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.kernels import rans as krans
    from hyres_tpu_torch.models import codec as tcodec
    from hyres_tpu_torch.models.hyres import HyresCodec, ResidualJPEGCompression
    from hyres_tpu_torch.utils import torch_convert as tc
    from hyres_tpu_torch.utils.convert import load_state_dict
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    t0 = time.perf_counter()
    config, params, _ = load_artifact(ARTIFACT)
    path = ROOT / "smoke_out" / "hyres_reference.pth.tar"
    path.parent.mkdir(exist_ok=True)
    try:
        size = _reference_pth(torch, np, params, path)
        t = time.perf_counter()
        imported = tc.convert_hyres(tc.load_pth(path))["params"]
        import_ms = (time.perf_counter() - t) * 1e3
    finally:
        path.unlink(missing_ok=True)
    got, want = dict(_leaves(imported)), dict(_leaves(params))
    check(sorted(got) == sorted(want), f"convert: the imported tree's keys differ: "
          f"{sorted(set(got) ^ set(want))[:6]}")
    bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                   and np.array_equal(got[k], want[k]))]
    check(not bad, f"convert: {len(bad)} leaves differ from the artifact's, e.g. {bad[:3]}")
    log("convert", f"{size / 2**20:.2f} MiB reference checkpoint (extras {len(REFERENCE_EXTRAS)} "
        f"dropped): load_pth + convert_hyres {import_ms:.1f} ms, {len(want)} leaves equal "
        "to the artifact's, leaf for leaf")

    codecs = {}
    for name, tree in (("imported", imported), ("artifact params", params)):
        model = ResidualJPEGCompression(config["N"], config["M"], config["jpeg_quality"])
        load_state_dict(model, tree)
        codec = codecs[name] = HyresCodec(model, coder="device", device=dev)
        t = time.perf_counter()
        check(codec.update(), f"convert: {name}: update() baked nothing")
        log("convert", f"{name}: update() {time.perf_counter() - t:.2f} s")
    requests = {"original": x, "hflip": x.flip(2).contiguous(), "vflip": x.flip(1).contiguous()}
    for codec in codecs.values():
        _roundtrip(torch, codec, x)  # warm-up
    dct.reset_launches()
    krans.reset_launches()
    tcodec.reset_wire_stats()
    runs = {req: _roundtrip(torch, codecs["imported"], xr) for req, xr in requests.items()}
    launches = {**dct.LAUNCHES, **krans.LAUNCHES}
    n = len(requests)
    want_l = {"fdct_quant_blocks": n, "dequant_idct_blocks": 2 * n, "encode_planes": n,
              "gauss_decode": 2 * n, "eb_decode": n, "gmm_rows": 0, "gmm_decode": 0}
    check(launches == want_l, f"convert: {n} roundtrips launched {launches}, not {want_l}")
    check(tcodec.WIRE_STATS["host_fallbacks"] == 0, "convert: the device coder fell back to "
          f"the host coder: {tcodec.WIRE_STATS['fallback_reasons']}")
    out = {"pth_bytes": size, "import_ms": import_ms, "launches": launches, "requests": {}}
    h, w = x.shape[1], x.shape[2]
    for req, xr in requests.items():
        comp, dec, t_c, t_d = runs[req]
        ref_comp, ref_dec, _, _ = _roundtrip(torch, codecs["artifact params"], xr)
        check(comp["strings"] == ref_comp["strings"]
              and comp["jpeg_buffers"] == ref_comp["jpeg_buffers"],
              f"convert/{req}: the imported codec's bytes differ from the artifact params'")
        check(torch.equal(dec["x_hat"], ref_dec["x_hat"]),
              f"convert/{req}: the imported codec's x_hat differs")
        for a, b in zip(comp["symbols"], dec["symbols"]):
            check(np.array_equal(_np(a), _np(b)), f"convert/{req}: symbols not exact")
        bpp = _nbytes(comp) * 8.0 / (h * w)
        psnr = _psnr(dec["x_hat"].float().cpu().numpy(), xr.cpu().numpy())
        out["requests"][req] = {"bpp": bpp, "psnr": psnr, "compress_ms": t_c * 1e3,
                                "decompress_ms": t_d * 1e3}
        log("convert", f"{req}: bytes identical and x_hat equal to the artifact params' "
            f"codec; bpp {bpp!r}, psnr {psnr!r} dB, compress {t_c * 1e3:.2f} ms, "
            f"decompress {t_d * 1e3:.2f} ms")
    comp, dec, _, _ = _roundtrip(torch, codec_tables, x)
    bpp_t = _nbytes(comp) * 8.0 / (h * w)
    psnr_t = _psnr(dec["x_hat"].float().cpu().numpy(), x.cpu().numpy())
    mine = out["requests"]["original"]
    check(abs(mine["bpp"] - bpp_t) <= CONVERT_BPP_RTOL * bpp_t
          and abs(mine["psnr"] - psnr_t) <= CONVERT_PSNR_ATOL_DB,
          f"convert: fresh bake bpp {mine['bpp']} / psnr {mine['psnr']} against the "
          f"artifact's tables {bpp_t} / {psnr_t}")
    out.update(artifact_tables={"bpp": bpp_t, "psnr": psnr_t},
               seconds=time.perf_counter() - t0)
    log("convert", f"against the artifact's baked tables: bpp {mine['bpp']!r} vs {bpp_t!r} "
        f"(rel {abs(mine['bpp'] - bpp_t) / bpp_t:.2g}), psnr {mine['psnr']!r} vs "
        f"{psnr_t!r} dB; launches {launches}; phase {out['seconds']:.1f} s")
    return out


# -- parallel --------------------------------------------------------------------

DP_TURNS = 10
SHARDED_RTOL = 1e-4              # sharded eval against make_eval_step's forward
SPATIAL_MEAN_ERR = 1e-3          # JAX's spatial contract (tests/test_parallel_inference.py)
SPATIAL_FLIP_SHARE = 0.02        # share of elements off by more than 1e-2
SPATIAL_HALO = 64


def _dp_step_vs_plain(torch, np, params, batches, dp, smi: str) -> dict:
    """(a) A DP step at the recipe against the plain step from the same
    state and generator seed; then DP_TURNS of each in alternating turns."""
    from hyres_tpu_torch.kernels import dct
    from hyres_tpu_torch.train import make_train_step

    def worst_leaf(got, want) -> tuple:
        w = (0.0, "")
        for n in want:
            w = max(w, (float((got[n] - want[n]).abs().max())
                        / max(float(want[n].abs().max()), 1e-30), n))
        return w

    xs = [torch.from_numpy(b).to(dp.device) for b in batches]
    # "again": a second plain step from the same state, for the card's own
    # run-to-run spread (cuDNN's autotuned backward is not deterministic)
    states = {k: _train_state(torch, _recipe_model(torch, params, None, dp.device))
              for k in ("plain", "dp", "again")}
    steps = {k: make_train_step(st, TRAIN_LMBDA, dp=dp if k == "dp" else None)
             for k, st in states.items()}
    gens = {k: torch.Generator(dp.device).manual_seed(5) for k in steps}
    first = {}
    for k in ("plain", "dp", "again"):
        dct.reset_launches()
        m = steps[k](xs[0], gens[k], True)
        torch.cuda.synchronize()
        first[k] = ({n: float(v) for n, v in m.items()}, dict(dct.LAUNCHES),
                    {n: p.grad.detach().clone() for n, p in states[k].model.named_parameters()})
    (mp_, _, gp), (md, ld, gd) = first["plain"], first["dp"]
    spread = worst_leaf(first["again"][2], gp)
    del states["again"], steps["again"], first["again"]
    check(ld == {"fdct_quant_blocks": 1, "dequant_idct_blocks": 1},
          f"parallel: a DP step launched K1/K2 {ld} times, not once each")
    check(md["skipped_nonfinite"] == 0 and math.isfinite(md["loss"]),
          f"parallel: the DP step was skipped or not finite: {md}")
    check(abs(md["loss"] - mp_["loss"]) <= STEP_LOSS_RTOL * abs(mp_["loss"]),
          f"parallel: DP loss {md['loss']} vs plain {mp_['loss']}")
    worst = worst_leaf(gd, gp)
    check(worst[0] <= STEP_GRAD_BAR, f"parallel: DP gradient {worst[1]}: {worst[0]:.3g} "
          "of its max |g|")
    params_dp = [p for g in states["dp"].main.param_groups + states["dp"].aux.param_groups
                 for p in g["params"]]
    ar_bytes = sum(p.numel() * p.element_size() for p in params_dp)
    log("parallel", f"DP step (world {dp.world}, {torch.distributed.get_backend()}) against "
        f"the plain step at B={TRAIN_B}, "
        f"{TRAIN_P}x{TRAIN_P}, f32: loss {md['loss']!r} vs {mp_['loss']!r} (rel "
        f"{abs(md['loss'] - mp_['loss']) / abs(mp_['loss']):.2g}); {len(gp)} gradient "
        f"leaves, worst {worst[0]:.3g} of its max |g| ({worst[1]}); two plain steps "
        f"differ by {spread[0]:.3g} ({spread[1]}); K1/K2 launches {ld}")
    times = {"plain": [], "dp": []}
    for i in range(DP_TURNS):
        for k in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
            ms, m = _timed_once(torch, lambda: steps[k](xs[(i + 1) % len(xs)], gens[k], True))
            check(float(m["skipped_nonfinite"]) == 0, f"parallel: a {k} step was skipped")
            times[k].append(ms)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log("parallel", f"{DP_TURNS} steps each in alternating turns: median plain "
        f"{med['plain']:.2f} ms, DP {med['dp']:.2f} ms ({smi}); the flat all-reduce "
        f"{ar_bytes} bytes a step ({len(params_dp)} leaves in one buffer); not gated")
    del states, steps
    torch.cuda.empty_cache()
    return {"loss_plain": mp_["loss"], "loss_dp": md["loss"], "worst_grad": list(worst),
            "plain_spread": list(spread), "launches": ld, "step_ms": times, "median_ms": med, "allreduce_bytes": ar_bytes}


def _sharded_eval(torch, np, params, images, dp) -> dict:
    """(b) make_sharded_eval on the three images against make_eval_step's
    forward, per image."""
    from hyres_tpu_torch.parallel import make_sharded_eval
    from hyres_tpu_torch.train import make_eval_step

    model = _recipe_model(torch, params, None, dp.device)
    batch = torch.cat(images)
    t = time.perf_counter()
    got = make_sharded_eval(model, dp)(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    _, out = make_eval_step(model, TRAIN_LMBDA)(batch)
    H, W = batch.shape[1:3]
    mse = torch.mean((torch.clamp(out["x_hat"], 0, 1) - batch) ** 2, dim=(1, 2, 3))
    want = {"psnr": -10.0 * torch.log10(mse),
            "bpp_est": sum(-torch.sum(torch.log2(l), dim=(1, 2, 3)) / (H * W)
                           for l in out["likelihoods"].values()) + out["jpeg_bpp_loss"]}
    worst = {}
    for k, v in want.items():
        rel = float(((got[k] - v).abs() / v.abs()).max())
        check(rel <= SHARDED_RTOL, f"parallel: sharded {k} {got[k].tolist()} vs "
              f"make_eval_step's {v.tolist()}")
        worst[k] = rel
    check(tuple(got["x_hat"].shape) == tuple(batch.shape), "parallel: sharded x_hat shape")
    log("parallel", f"make_sharded_eval on {tuple(batch.shape)}: {ms:.1f} ms; psnr "
        f"{[round(v, 4) for v in got['psnr'].tolist()]} dB, bpp_est "
        f"{[round(v, 4) for v in got['bpp_est'].tolist()]}; worst rel against "
        f"make_eval_step {worst}")
    return {"ms": ms, "psnr": got["psnr"].tolist(), "bpp_est": got["bpp_est"].tolist(),
            "worst_rel": worst}


def _spatial(torch, np, params, x, dev) -> dict:
    """(c) strip_forward of the artifact's residual model on the image's
    JPEG residual, strips 0 and 1 of 2, against the unsharded forward
    under the coder path's deterministic flags."""
    from hyres_tpu_torch.jpeg import jpeg_roundtrip
    from hyres_tpu_torch.parallel import strip_forward

    model = _recipe_model(torch, params, None, dev).residual_model.eval()
    with torch.no_grad():
        residual = x - jpeg_roundtrip(x, 1)[0]
        want = model(residual, noisequant=False)["x_hat"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    strips = [strip_forward(model, residual, i, 2, SPATIAL_HALO) for i in range(2)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    err = (torch.cat([s[0] for s in strips], dim=1) - want).abs()[0].cpu().numpy()
    H = err.shape[0]
    interior = np.abs(np.arange(H) - H // 2) > 48
    stats = {"mean_err": float(err.mean()), "share_gt_1e-2": float(np.mean(err > 1e-2)),
             "interior_max": float(err[interior].max()),
             "bits": float(sum(s[1] for s in strips))}
    check(stats["mean_err"] < SPATIAL_MEAN_ERR and stats["share_gt_1e-2"] < SPATIAL_FLIP_SHARE,
          f"parallel: spatial strips against the unsharded forward: {stats}")
    log("parallel", f"strip_forward of the residual model (N=128, M=192), 2 strips of "
        f"{H // 2} rows, halo {SPATIAL_HALO}, on the {tuple(x.shape[1:3])} residual: "
        f"{ms:.1f} ms; mean abs err {stats['mean_err']:.3g}, share > 1e-2 "
        f"{stats['share_gt_1e-2']:.3g}, interior max {stats['interior_max']:.3g} (not "
        f"gated), valid-row bits {stats['bits']:.1f}; flags {_cudnn_flags(torch)}")
    return {"ms": ms, **stats}


def phase_parallel(torch, x, smi: str, dev: str = "cuda") -> dict:
    """Data parallelism on a single-rank NCCL group (the machine has one
    card): the DP train step against the plain step, the sharded eval
    against make_eval_step's forward, and the spatial strips."""
    import os

    import numpy as np

    from hyres_tpu_torch.parallel import (data_parallel_mesh, local_device,
                                          maybe_initialize_distributed)
    from hyres_tpu_torch.utils.flax_msgpack import load_artifact

    t0 = time.perf_counter()
    flags = _cudnn_flags(torch)
    os.environ["HYRES_MULTIHOST"] = "1"  # a group of one, without torchrun
    try:
        check(maybe_initialize_distributed(dev), "parallel: no process group was made")
        dev = local_device(dev)
        dp = data_parallel_mesh(dev)
        log("parallel", f"process group: backend {torch.distributed.get_backend()}, rank "
            f"{dp.rank} of {dp.world} on {dev}")
        _, params, _ = load_artifact(ARTIFACT)
        img = x[0].cpu().numpy()
        rng = np.random.default_rng(2027)
        batches = [_crops(np, rng, [img, img[:, ::-1], img[::-1]], TRAIN_B) for _ in range(2)]
        out = {"train": _dp_step_vs_plain(torch, np, params, batches, dp, smi)}
        out["sharded_eval"] = _sharded_eval(
            torch, np, params, [x, x.flip(2).contiguous(), x.flip(1).contiguous()], dp)
        out["spatial"] = _spatial(torch, np, params, x, dev)
    finally:
        del os.environ["HYRES_MULTIHOST"]
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    check(_cudnn_flags(torch) == flags, f"parallel changed the process-wide flags: "
          f"{flags} -> {_cudnn_flags(torch)}")
    out["seconds"] = time.perf_counter() - t0
    log("parallel", f"phase done in {out['seconds']:.1f} s")
    return out


def main(alone: str | None = None) -> int:
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
        if alone is not None:
            return _alone_main(torch, x, smi, kind, alone)
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
        main_out["refine"] = phase_refine(torch, x, codecs[("device", "f32")], smi)
        main_out["baselines"] = phase_baselines(torch, x, smi)
        main_out["tcm"] = phase_tcm(torch, x)
        main_out["profile"] = phase_profile(torch, codecs, x)
        main_out["convert"] = phase_convert(torch, x, codecs[("device", "f32")])
        main_out["parallel"] = phase_parallel(torch, x, smi)
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
    kernels += _gmm_kernel_lines(main_out["baselines"]["cheng2020-gmm"])
    kernels += _tcm_kernel_lines(main_out["tcm"])
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


def _alone_main(torch, x, smi: str, kind: str, what: str) -> int:
    """``--gmm``: the mixture variant of the baselines phase alone; ``--tcm``:
    the TCM phase alone."""
    if what == "gmm":
        got, lines = _baseline_gmm(torch, x), _gmm_kernel_lines
    else:
        got, lines = phase_tcm(torch, x), _tcm_kernel_lines
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"chip_smoke_{what}.json").write_text(json.dumps(
        {"nvidia_smi": smi, {"gmm": "cheng2020-gmm"}.get(what, what): got}, indent=1))
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": lines(got)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--large-batch"]:
        sys.exit(large_batch_child(Path(sys.argv[2])))
    flag = {"--gmm": "gmm", "--tcm": "tcm"}
    sys.exit(main(alone=flag[sys.argv[1]] if sys.argv[1:2] and sys.argv[1] in flag else None))
