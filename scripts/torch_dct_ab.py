#!/usr/bin/env python3
"""Same-call A/B of the port's DCT kernels (K1, K2) against another checkout's.

    python3 scripts/torch_dct_ab.py --baseline DIR [--reps 50] [--requests 5]
        [--variants NAME ...] [--timeline [NAME]]

Runs on one NVIDIA GPU, from the root of a checkout. ``DIR`` is the root
of another checkout (for example one unpacked with ``git archive``) whose
``hyres_tpu_torch/kernels/csrc/dct.cu`` has the per-plane interface
(``hyk_fdct_quant(blocks, m, q, out, n, stream)`` on (N, 64) blocks with
a device quant table). The baseline runs with a copy of that interface's
Python glue (``Baseline``): per plane a quant-table upload (a pageable
host-to-device copy, which synchronises), a blockify copy in, one
launch, an unblockify copy out, and int8/int16 coefficients cast to
int32 first.

* Equality: on the smoke's three planes (the in-repo 768x512 image) and
  on seeded random planes (B=2, ragged block counts), this checkout's
  fused calls must give ``torch.equal`` outputs to the baseline's
  per-plane calls: K1, and K2 on int32, int8 and int16 coefficients.
* Timing, in turns baseline, this, this, baseline: torch.profiler's
  device time of all the device work of each path on the smoke's
  planes (K1; K2 from int32 as compress gives it; K2 from int8 as
  decompress gives it), with the baseline's kernels alone beside it and
  CUDA events around back-to-back calls.
* Roundtrips, in the same turns: the smoke's three requests through
  ``HyresCodec(coder="device")`` in bf16 and f32 with each build's JPEG
  path; median compress/decompress walls, the synchronising calls of one
  request (sync-debug "warn"), and frames, JFIF bytes and decoded images
  that must match between the builds.
* ``--variants``: other designs of this checkout's kernels (``VARIANTS``,
  text edits of its ``dct.cu``) timed in the same turns, between the
  two "this" turns and mirrored, and compared with its outputs.
* ``--timeline``: a build whose thread 0 of each CTA stamps ``clock64``
  at the phases of its first two tiles; prints the cycles of each span
  (median and max over CTAs) for one K1 and one K2 call.

Writes everything to ``smoke_out/torch_dct_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import _syncs  # noqa: E402
from torch_rans_ab import build  # noqa: E402

from hyres_tpu_torch.jpeg import core, tables  # noqa: E402
from hyres_tpu_torch.kernels import dct  # noqa: E402
from hyres_tpu_torch.models.hyres import HyresCodec  # noqa: E402
from hyres_tpu_torch.utils.png import load_image  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
TURNS = ("baseline", "this", "this", "baseline")


# Designs timed beside this checkout's kernels (``--variants``): text edits
# of its csrc/dct.cu, each (old, new) applied once. Those marked
# timing-only compute something else on purpose and are not held equal.
VARIANTS = {
    "matrix-const": ("timing-only: no matrix load, a constant column", [
        ("m[k] = __ldg(a.m + k * 64 + c);", "m[k] = 0.001f * (k + c);")]),
    "one-cta-an-sm": ("grid of one CTA an SM", [
        ("constexpr int kCtasPerSm = 2;", "constexpr int kCtasPerSm = 1;")]),
    "rows-8": ("8 blocks a thread at once (32-block tiles), one CTA an SM", [
        ("constexpr int kRows = 4; ", "constexpr int kRows = 8; "),
        ("constexpr int kCtasPerSm = 2;", "constexpr int kCtasPerSm = 1;")]),
    "x-once": ("timing-only: each row's float4 read once a tile, not once per 4 k", [
        ("const float4 v = x4[j * 16 + kk];", "const float4 v = x4[j * 16];")]),
    # thread 0 of each CTA stamps (clock64) its start, the first two
    # tiles' phases and its end, and records its SM and tile count
    "timeline": ("timing-only: a per-CTA clock64 timeline (--timeline)", [
        ("constexpr int kMaxPlanes = 3;",
         "__device__ long long g_tl[24 * 4096];\n"
         "#define STAMP(i) do { if ((i) < 20) ts[(i)] = clock64(); } while (0)\n"
         "constexpr int kMaxPlanes = 3;"),
        ("  const int grp = tid >> 6;",
         "  long long ts[20] = {0};\n  int nt = 0;\n  STAMP(0);\n"
         "  const int grp = tid >> 6;"),
        ("    if (tile < a.ntiles) {\n", "    if (tile < a.ntiles) {\n"
         "      if (tile == static_cast<int>(blockIdx.x)) STAMP(1);\n"),
        ("        cp_async16(&raw[s][row * 64 + kPerChunk * part], src);\n      }\n",
         "        cp_async16(&raw[s][row * 64 + kPerChunk * part], src);\n      }\n"
         "      if (tile == static_cast<int>(blockIdx.x)) STAMP(2);\n"),
        ("  issue(blockIdx.x + gridDim.x, 1);", "  issue(blockIdx.x + gridDim.x, 1);\n  STAMP(3);"),
        ("m[k] = __ldg(a.m + k * 64 + c);",
         "m[k] = __ldg(a.m + k * 64 + c);\n  asm volatile(\"\" :: \"f\"(m[0]), \"f\"(m[63]));\n"
         "  STAMP(4);"),
        ("    cp_async_wait<1>();  // this tile's group; the next may stay in flight",
         "    cp_async_wait<1>();  // this tile's group; the next may stay in flight\n"
         "    STAMP(5 + 6 * nt);"),
        ("    __syncthreads();     // ... for every thread; xs is free again",
         "    __syncthreads();     // ... for every thread; xs is free again\n"
         "    STAMP(6 + 6 * nt);"),
        ("    __syncthreads();\n    issue(tile + 2 * gridDim.x, s);",
         "    __syncthreads();\n    STAMP(7 + 6 * nt);\n    issue(tile + 2 * gridDim.x, s);\n"
         "    STAMP(8 + 6 * nt);"),
        ("#pragma unroll\n    for (int j = 0; j < kRows; ++j) {\n      const int g = g0 + grp * kRows + j;",
         "    asm volatile(\"\" :: \"f\"(acc[0]), \"f\"(acc[kRows - 1]));\n"
         "    STAMP(9 + 6 * nt);\n"
         "#pragma unroll\n    for (int j = 0; j < kRows; ++j) {\n      const int g = g0 + grp * kRows + j;"),
        ("    }\n  }\n  cp_async_wait<0>();\n}",
         "    }\n    STAMP(10 + 6 * nt);\n    nt = nt < 1 ? nt + 1 : 2;\n  }\n"
         "  cp_async_wait<0>();\n"
         "  if (tid == 0 && blockIdx.x < 4096) {\n"
         "    long long* r = g_tl + 24 * blockIdx.x;\n"
         "    for (int i = 0; i < 20; ++i) r[i] = ts[i];\n"
         "    unsigned smid;\n"
         "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(smid));\n"
         "    r[20] = clock64(); r[21] = smid; r[22] = gridDim.x;\n"
         "  }\n}"),
        ('}  // extern "C"',
         'int hyk_timeline(void* out) {\n'
         '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl)));\n}\n\n'
         '}  // extern "C"')]),
    "ldg-staging": ("tile rows staged by a 16-byte load and store a thread, not cp.async", [
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(smem_u32(dst)),\n'
         '               "l"(src)\n               : "memory");',
         "*static_cast<int4*>(dst) = __ldg(static_cast<const int4*>(src));")]),
    "empty": ("timing-only: each CTA returns at once", [
        ("  const int tid = threadIdx.x;\n  const int c",
         "  if (a.total > 0) return;\n  const int tid = threadIdx.x;\n  const int c")]),
}


def build_variant(name: str) -> ctypes.CDLL:
    """Build the variant ``name``; ``a+b`` applies a's edits, then b's."""
    src = (ROOT / "hyres_tpu_torch" / "kernels" / "csrc" / "dct.cu").read_text()
    for part in name.split("+"):
        for old, new in VARIANTS[part][1]:
            if src.count(old) != 1:
                raise SystemExit(f"variant {part}: the text to replace is not in dct.cu once")
            src = src.replace(old, new)
    path = ROOT / "smoke_out" / "dct_variants" / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = build(path, f"hyres_dct_{name}")
    own = dct._lib()
    for fn in ("hyk_fdct_quant", "hyk_dequant_idct"):
        getattr(lib, fn).argtypes = getattr(own, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


class Baseline:
    """The per-plane K1/K2 path on the baseline's library, with the same
    call names as ``kernels/dct.py`` so that ``jpeg/core.py`` can run on
    it."""

    def __init__(self, src: Path):
        self.lib = build(src, "hyres_dct_baseline")
        for fn in (self.lib.hyk_fdct_quant, self.lib.hyk_dequant_idct):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    @staticmethod
    def launch(fn, x: torch.Tensor, q: torch.Tensor, out_dtype, forward: bool):
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        rc = fn(x.data_ptr(), dct._matrix(x.device, forward).data_ptr(), q.data_ptr(),
                out.data_ptr(), x.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed (cudaError {rc})")
        return out

    @staticmethod
    def qtable(qtbl, device) -> torch.Tensor:
        return torch.as_tensor(qtbl, dtype=torch.float32).reshape(64).to(device)

    def fdct_quant(self, plane, qtbl):
        blocks = dct.blockify(plane.to(torch.float32))
        flat = blocks.reshape(-1, 64).contiguous()
        coef = self.launch(self.lib.hyk_fdct_quant, flat, self.qtable(qtbl, plane.device),
                           torch.int32, True)
        return coef.reshape(blocks.shape)

    def dequant_idct(self, coef, qtbl):
        flat = coef.reshape(-1, 64).to(torch.int32).contiguous()
        pix = self.launch(self.lib.hyk_dequant_idct, flat, self.qtable(qtbl, coef.device),
                          torch.float32, False)
        return dct.unblockify(pix.reshape(coef.shape))

    def fdct_quant_planes(self, planes, qtables):
        return [self.fdct_quant(p, q) for p, q in zip(planes, qtables)]

    def dequant_idct_planes(self, coefs, qtables):
        return [self.dequant_idct(c, q) for c, q in zip(coefs, qtables)]


def smoke_planes():
    x = torch.from_numpy(load_image(IMAGE)).cuda()
    qy, qc = tables.quality_to_qtables(1)
    y, cb, cr = core.rgb_to_ycbcr(core.pad_to_multiple(x, 16))
    return x, [y, core.downsample_420(cb), core.downsample_420(cr)], [qy, qc, qc]


def random_planes():
    rng = np.random.default_rng(8)
    qy, qc = tables.quality_to_qtables(50)
    shapes = [(2, 40, 56), (2, 24, 16), (2, 8, 72)]
    planes = [torch.from_numpy(np.round(rng.random(s) * 255).astype(np.float32)).cuda()
              for s in shapes]
    return planes, [qy, qc, qc]


def check_equal(base: Baseline) -> dict:
    out = {}
    fine = [np.full(64, 4.0, np.float32)] * 3
    for label, (planes, qts) in (("smoke", smoke_planes()[1:]), ("random", random_planes())):
        got, want = dct.fdct_quant_planes(planes, qts), base.fdct_quant_planes(planes, qts)
        res = {"K1": all(torch.equal(a, b) for a, b in zip(got, want))}
        c16 = [c.to(torch.int16) for c in dct.fdct_quant_planes(planes, fine)]
        for dt, coefs, qq in (("int32", got, qts), ("int8", [c.to(torch.int8) for c in got], qts),
                              ("int16", c16, fine)):
            a, b = dct.dequant_idct_planes(coefs, qq), base.dequant_idct_planes(coefs, qq)
            res[f"K2 {dt}"] = all(torch.equal(u, v) for u, v in zip(a, b))
        torch.cuda.synchronize()
        out[label] = res
        print(f"equality on the {label} planes ({sum(p.numel() for p in planes) // 64} "
              f"blocks): {res}", flush=True)
        if not all(res.values()):
            raise SystemExit(f"{label} planes: the fused calls differ from the baseline's")
    return out


def _us(e) -> float:
    """Device time of a profiler event in us (newer torch names it
    ``device_time_total``, older ``cuda_time_total``)."""
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else getattr(e, "cuda_time_total", 0.0))


def device_ms(fn, reps: int, warmup: int = 3):
    """(device ms a call, {device op: us a call}) over ``reps`` calls,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not evs:
        raise SystemExit("torch.profiler traced no device work")
    by = {}
    for e in evs:
        by[e.name] = by.get(e.name, 0.0) + _us(e) / reps
    return sum(by.values()) / 1e3, by


def event_ms(fn, reps: int) -> float:
    """ms a call between two CUDA events around ``reps`` back-to-back
    calls (host work and synchronisations included)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timing(base: Baseline, reps: int, variants: dict) -> dict:
    _, planes, qts = smoke_planes()
    c32 = dct.fdct_quant_planes(planes, qts)
    c8 = [c.to(torch.int8) for c in c32]
    paths = {
        "K1 (compress, f32 planes)": {
            "baseline": lambda: base.fdct_quant_planes(planes, qts),
            "this": lambda: dct.fdct_quant_planes(planes, qts)},
        "K2 from int32 (compress)": {
            "baseline": lambda: base.dequant_idct_planes(c32, qts),
            "this": lambda: dct.dequant_idct_planes(c32, qts)},
        "K2 from int8 (decompress)": {
            "baseline": lambda: base.dequant_idct_planes(c8, qts),
            "this": lambda: dct.dequant_idct_planes(c8, qts)},
    }
    # yardstick: PyTorch's copy of K1's bytes (the f32 planes in, as many
    # 4-byte words out), the same call in every turn
    outs = [torch.empty_like(p) for p in planes]
    copy = {"this": lambda: [o.copy_(p) for o, p in zip(outs, planes)]}
    copy["baseline"] = copy["this"]
    paths["copy of K1's bytes (yardstick)"] = copy
    # the baseline's kernels alone: three launches on inputs already laid
    # out as (N, 64) blocks, the tables already on the card
    flats = [dct.blockify(p).reshape(-1, 64).contiguous() for p in planes]
    cflats = [c.reshape(-1, 64).contiguous() for c in c32]
    qdev = [base.qtable(q, planes[0].device) for q in qts]
    kernels_alone = {
        "K1 (compress, f32 planes)": lambda: [base.launch(
            base.lib.hyk_fdct_quant, f, q, torch.int32, True) for f, q in zip(flats, qdev)],
        "K2 from int32 (compress)": lambda: [base.launch(
            base.lib.hyk_dequant_idct, f, q, torch.float32, False) for f, q in zip(cflats, qdev)],
    }
    for k, fns in paths.items():
        for name, lib in variants.items():
            fns[name] = lambda lib=lib, fn=fns["this"]: with_lib(lib, fn)
    turns = TURNS[:2] + tuple(variants) + tuple(reversed(variants)) + TURNS[2:]
    res = {k: {"baseline_kernels_ms": [],
               **{f"{t}{x}": ([] if x != "_ops_us" else {}) for t in set(turns)
                  for x in ("_ms", "_call_ms", "_ops_us")}} for k in paths}
    for k, fns in paths.items():
        if variants:
            want = fns["this"]()
            for name in variants:
                got = fns[name]()
                res[k][f"{name}_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for turn in turns:
            for k, fns in paths.items():
                ms, by = device_ms(fns[turn], reps)
                call = event_ms(fns[turn], reps)
                r = res[k]
                r[f"{turn}_ms"].append(ms)
                r[f"{turn}_call_ms"].append(call)
                r[f"{turn}_ops_us"] = by
                extra = ""
                if turn == "baseline" and k in kernels_alone:
                    kms, _ = device_ms(kernels_alone[k], reps)
                    r["baseline_kernels_ms"].append(kms)
                    extra = f"; its 3 kernels alone {kms:.5f}"
                print(f"{turn:14s} {k:28s} device {ms:.5f} ms a call{extra}; CUDA events "
                      f"{call:.5f} ms; ops (us): "
                      + ", ".join(f"{n[:40]} {v:.3f}" for n, v in sorted(by.items())),
                      flush=True)
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
    mhz = sorted(float(s.split(",")[0]) for s in samples if s.strip())
    if mhz:
        res["sm_mhz"] = {"min": mhz[0], "median": mhz[len(mhz) // 2], "max": mhz[-1]}
        print(f"SM clock over the turns: {res['sm_mhz']} MHz ({len(mhz)} samples)", flush=True)
    return res


SPANS = ["start to the first copy", "tile 0: copies issued", "tile 1: copies issued",
         "matrix column to registers",
         *[f"tile {t}: {x}" for t in (0, 1) for x in (
             "wait for its copy", "barrier", "prologue + barrier", "issue the tile after next",
             "FMAs", "epilogue and stores")]]


def timeline(base_variant: str = "") -> dict:
    """One K1 and one K2 (int8) call on the smoke's planes with the
    ``timeline`` build (on top of ``base_variant``'s edits, if given):
    cycles of each span of thread 0 of a CTA (median and max over CTAs),
    and each CTA's total. Tile 0's wait includes staging the quant
    tables."""
    lib = build_variant(f"{base_variant}+timeline" if base_variant else "timeline")
    lib.hyk_timeline.argtypes = [ctypes.c_void_p]
    _, planes, qts = smoke_planes()
    c8 = [c.to(torch.int8) for c in dct.fdct_quant_planes(planes, qts)]
    out = {}
    for k, fn in (("K1", lambda: dct.fdct_quant_planes(planes, qts)),
                  ("K2 from int8", lambda: dct.dequant_idct_planes(c8, qts))):
        with_lib(lib, fn)  # warm-up
        torch.cuda.synchronize()
        with_lib(lib, fn)
        torch.cuda.synchronize()
        buf = np.zeros((4096, 24), np.int64)
        if lib.hyk_timeline(buf.ctypes.data) != 0:
            raise SystemExit("timeline: copy failed")
        r = buf[:int(buf[0, 22])]
        d = np.diff(r[:, :17], axis=1)
        res = {name: {"median": float(np.median(d[:, i])), "max": float(d[:, i].max())}
               for i, name in enumerate(SPANS)}
        res["CTA total"] = {"median": float(np.median(r[:, 20] - r[:, 0])),
                            "max": float((r[:, 20] - r[:, 0]).max())}
        out[k] = res
        print(f"timeline {k}, grid {len(r)}: cycles of thread 0 (median, max over CTAs)",
              flush=True)
        for name, v in res.items():
            print(f"   {name:40s} {v['median']:8.0f} {v['max']:8.0f}", flush=True)
    return out


def with_lib(lib, fn):
    """``fn()`` with the package's K1/K2 calls on another build."""
    own = dct._lib
    dct._lib = lambda: lib
    try:
        return fn()
    finally:
        dct._lib = own


def roundtrips(base: Baseline, n: int) -> dict:
    """Median walls and synchronising calls of the device-coder roundtrip
    with each build's JPEG path, in turns."""
    x = torch.from_numpy(load_image(IMAGE)).cuda()
    requests = [x, x.flip(2).contiguous(), x.flip(1).contiguous()]
    codecs = {name: HyresCodec.from_artifact(ARTIFACT, compute_dtype=dt, device="cuda",
                                             coder="device")
              for name, dt in (("bf16", torch.bfloat16), ("f32", None))}
    own = core.dct
    out, first = {}, {}
    try:
        for turn in TURNS:
            core.dct = base if turn == "baseline" else own
            for name, codec in codecs.items():
                codec.decompress(codec.compress(x))  # warm-up
                walls = []
                for _ in range(n):
                    for xr in requests:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        comp = codec.compress(xr)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        codec.decompress(comp)
                        torch.cuda.synchronize()
                        walls.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
                s_c, comp = _syncs(torch, lambda: codec.compress(x))
                s_d, dec = _syncs(torch, lambda: codec.decompress(comp))
                s_c, s_d = len(s_c), len(s_d)
                got = (comp["strings"], comp["jpeg_buffers"], dec["x_hat"].cpu())
                ref = first.setdefault(name, got)
                same = {"frames": got[0] == ref[0], "jfif": got[1] == ref[1],
                        "x_hat": torch.equal(got[2], ref[2])}
                if not (same["frames"] and same["jfif"]):
                    raise SystemExit(f"{name}: the builds' frames or JFIF bytes differ")
                c = sorted(w[0] for w in walls)[len(walls) // 2]
                d = sorted(w[1] for w in walls)[len(walls) // 2]
                out.setdefault(f"{name}/{turn}", []).append(
                    {"compress_ms": c, "decompress_ms": d, "compress_syncs": s_c,
                     "decompress_syncs": s_d, "same_as_first_turn": same})
                print(f"{turn:8s} device coder {name}: median of {len(walls)} requests "
                      f"compress {c:.2f} ms, decompress {d:.2f} ms; syncs a request "
                      f"compress {s_c}, decompress {s_d}; same as the first turn {same}",
                      flush=True)
    finally:
        core.dct = own
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="root of the checkout to time against")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--requests", type=int, default=5,
                    help="rounds of the 3 requests a turn (0: no roundtrips)")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="other designs of this checkout's kernels to time beside it")
    ap.add_argument("--timeline", nargs="?", const="", default=None, metavar="VARIANT",
                    help="per-CTA timeline of one K1 and one K2 call (of a variant)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dct_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    base = Baseline(args.baseline / "hyres_tpu_torch" / "kernels" / "csrc" / "dct.cu")
    if args.timeline is not None:
        out_tl = timeline(args.timeline)
    variants = {name: build_variant(name) for name in args.variants}
    out = {"nvidia_smi": smi, "equal": check_equal(base),
           "variants": {name: "; then ".join(VARIANTS[v][0] for v in name.split("+"))
                        for name in variants},
           "timing": timing(base, args.reps, variants)}
    if args.timeline is not None:
        out["timeline"] = out_tl
    if args.requests:
        out["roundtrips"] = roundtrips(base, args.requests)
    out["seconds"] = time.perf_counter() - t0
    (ROOT / "smoke_out").mkdir(exist_ok=True)
    (ROOT / "smoke_out" / "torch_dct_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
