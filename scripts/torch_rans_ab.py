#!/usr/bin/env python3
"""Same-call A/B and clock64 step split of the port's rANS kernels (K3-K5).

    python3 scripts/torch_rans_ab.py --baseline DIR [--reps 20] [--split]

Runs on one NVIDIA GPU, from the root of a checkout.

* A/B: builds ``DIR/hyres_tpu_torch/kernels/csrc/rans.cu`` (another
  checkout of the repository, for example one unpacked with
  ``git archive``) and this checkout's ``rans.cu`` with the flags of
  ``kernels/build.py``; takes the planes of one real request (the smoke's
  768x512 image through the float32 device coder: z at 64 lanes, T=768;
  the anchor and non-anchor y halves at 128 lanes, T=4,608); checks that
  both builds give the same streams, states, word counts and symbols;
  and times each kernel of both builds on those planes, in turns
  baseline, this, this, baseline: device time from torch.profiler (as
  ``chip_smoke.py`` does) and, beside it, CUDA events around ``--reps``
  back-to-back calls. Prints ms and us a serial step. Then, in the same
  turns, it serves the smoke's three requests through
  ``HyresCodec(coder="device")`` in bf16 and f32 with each build and
  prints the median compress and decompress walls (the frames must be
  byte-identical between the builds).
* ``--split``: builds ``scripts/rans_split/warp.cu``, a copy of K3-K5
  of ``rans.cu`` with ``clock64`` spans in the step loop, runs K3 and K4
  on the anchor y half and K5 on z, and prints the cycles a step of every
  span (mean over threads, and thread 0). The instrumented loop runs
  slower than the kernel, so a span is a share of the step, not a time.

Writes everything to ``smoke_out/torch_rans_ab.json``.
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

from hyres_tpu_torch.coding import build as coding_build  # noqa: E402
from hyres_tpu_torch.coding import device_rans as dr  # noqa: E402
from hyres_tpu_torch.kernels import build as kbuild  # noqa: E402
from hyres_tpu_torch.kernels import rans as krans  # noqa: E402
from hyres_tpu_torch.models.codec import DevicePlaneCoder  # noqa: E402
from hyres_tpu_torch.models.hyres import HyresCodec  # noqa: E402
from hyres_tpu_torch.utils.png import load_image  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
SPLIT = ROOT / "scripts" / "rans_split"


def build(src: Path, name: str) -> ctypes.CDLL:
    """nvcc ``src`` as kernels/build.py does; print ptxas' registers/spills."""
    lib = coding_build.build_cached(
        name, [src], lambda srcs, out: [kbuild.nvcc(), "-gencode", kbuild.ARCH, "-O3",
                                        "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                                        "-Xptxas", "-v", "-o", out, *srcs])
    for line in Path(str(lib) + ".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  {name} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


class _Lib:
    """The package's calls on another build of rans.cu. A build whose K3
    takes no work buffer gets its plane descriptors without that field."""

    def __init__(self, cdll: ctypes.CDLL):
        ref = krans._lib()
        self._work = getattr(cdll, "hyk_rans_encode_work", None)
        if self._work is not None:
            self._work.argtypes = ref.hyk_rans_encode_work.argtypes
            self._work.restype = ctypes.c_int64
        fields = [f for f in krans._EncPlaneC._fields_
                  if self._work is not None or f[0] != "work"]
        self._desc = type("Desc", (ctypes.Structure,), {"_fields_": fields})
        self._enc = cdll.hyk_rans_encode
        self._enc.argtypes = [ctypes.c_void_p] + ref.hyk_rans_encode.argtypes[1:]
        self._enc.restype = ctypes.c_int
        self.hyk_rans_decode = cdll.hyk_rans_decode
        self.hyk_rans_decode.argtypes = ref.hyk_rans_decode.argtypes
        self.hyk_rans_decode.restype = ctypes.c_int

    def hyk_rans_encode_work(self, T, lanes, cap):
        return self._work(T, lanes, cap) if self._work is not None else 0

    def hyk_rans_encode(self, descs, n, max_lanes, cs):
        own = (self._desc * n)()
        for d, o in zip(descs, own):
            for name, _ in self._desc._fields_:
                setattr(o, name, getattr(d, name))
        return self._enc(ctypes.addressof(own), n, max_lanes, cs)

    @staticmethod
    def hyk_rans_decode_smem(*_):
        return 0  # the build refuses a launch it cannot fit


def request_planes():
    """Encode jobs and decode calls of one real request's three planes."""
    codec = HyresCodec.from_artifact(ARTIFACT, device="cuda", coder="device")
    x = torch.from_numpy(load_image(IMAGE)).cuda()
    dc = codec.device_coder
    with torch.inference_mode():
        z_sym, ((a_sym, a_idx), (n_sym, n_idx)) = codec.latents(x)
    jobs = codec.device_jobs(z_sym, [(a_sym, a_idx), (n_sym, n_idx)])
    encs = dr.encode(jobs)
    decodes = {}
    for label, kern, enc, n, idx, tab, aux in (
            ("z", krans.eb_decode, encs[0], z_sym[0].numel(),
             dc._z_idx(z_sym.shape, x.device), dc.eb.bounds, dc.eb.offset),
            ("anchor", krans.gauss_decode, encs[1], a_sym[0].numel(), a_idx,
             dc.gauss.bounds, dc.gauss.params),
            ("non-anchor", krans.gauss_decode, encs[2], n_sym[0].numel(), n_idx,
             dc.gauss.bounds, dc.gauss.params)):
        frames = DevicePlaneCoder.frames_from_enc({k: v.cpu().numpy() for k, v in enc.items()})
        lanes, states, stream, ep, ev = DevicePlaneCoder.unframe_batch(frames, n)
        T = -(-n // lanes)
        decodes[label] = (kern, (dr.to_tl(idx.reshape(1, -1), T, lanes, 0), tab, aux,
                                 torch.from_numpy(stream.view(np.int16)).cuda(),
                                 torch.from_numpy(states.view(np.int32)).cuda(),
                                 torch.from_numpy(ep).cuda(), torch.from_numpy(ev).cuda()), T)
    return jobs, decodes


def _dev_us(e) -> float:
    """Device time of a profiler event in us (newer torch names it
    ``device_time_total``, older ``cuda_time_total``)."""
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else getattr(e, "cuda_time_total", 0.0))


def _device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time a call: the summed duration of the device work ``fn``
    launches, traced by torch.profiler over ``reps`` calls."""
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
    return sum(_dev_us(e) for e in evs) / reps / 1e3


def _event_ms(fn, reps: int) -> float:
    """ms a call over ``reps`` back-to-back calls between two CUDA events:
    the kernels are longer than a call's host work, so the stream stays
    busy and the time is the device's."""
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


def ab(baseline: Path, reps: int) -> dict:
    libs = {"baseline": _Lib(build(baseline / "hyres_tpu_torch" / "kernels" / "csrc" / "rans.cu",
                                   "hyres_rans_baseline")),
            "this": krans._lib()}
    jobs, decodes = request_planes()
    planes = [j.plane for j in jobs]
    T3 = max(p.start.shape[1] for p in planes)
    own = krans._lib

    def with_lib(lib, fn):
        krans._lib = lambda: lib
        try:
            return fn()
        finally:
            krans._lib = own

    calls = {"K3 encode_planes (z + both y halves)": (lambda: krans.encode_planes(planes), T3)}
    for label, (kern, args, T) in decodes.items():
        k = "K5 eb_decode" if label == "z" else "K4 gauss_decode"
        calls[f"{k} ({label})"] = (lambda kern=kern, args=args: kern(*args), T)
    outs = {}
    for name, lib in libs.items():
        outs[name] = {k: with_lib(lib, fn) for k, (fn, _) in calls.items()}
        torch.cuda.synchronize()
    for k in calls:
        a, b = outs["baseline"][k], outs["this"][k]
        same = (all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))
                if isinstance(a, list) else torch.equal(a, b))
        if not same:
            raise SystemExit(f"{k}: the two builds disagree")
    print("outputs identical between the builds", flush=True)
    res = {k: {"T": T, "baseline_ms": [], "this_ms": [], "baseline_call_ms": [],
               "this_call_ms": [], "baseline_ms_5": [], "this_ms_5": []}
           for k, (_, T) in calls.items()}
    # the SM clock while the turns run (nvidia-smi samples every 100 ms)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for turn in ("baseline", "this", "this", "baseline"):
            for k, (fn, T) in calls.items():
                ms = with_lib(libs[turn], lambda: _device_ms(fn, reps))
                ms5 = with_lib(libs[turn], lambda: _device_ms(fn, 5, warmup=1))
                call = with_lib(libs[turn], lambda: _event_ms(fn, reps))
                res[k][f"{turn}_ms"].append(ms)
                res[k][f"{turn}_ms_5"].append(ms5)
                res[k][f"{turn}_call_ms"].append(call)
                print(f"{turn:8s} {k:40s} device {ms:8.4f} ms, {ms / T * 1e3:7.4f} us a "
                      f"step (T={T}); over 5 calls {ms5:8.4f}; call {call:8.4f} ms",
                      flush=True)
    finally:
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
    mhz = sorted(float(x.split(",")[0]) for x in samples if x.strip())
    if mhz:
        res["sm_mhz"] = {"min": mhz[0], "median": mhz[len(mhz) // 2], "max": mhz[-1]}
        print(f"SM clock over the turns: {res['sm_mhz']} MHz ({len(mhz)} samples)", flush=True)
    res["roundtrips"] = roundtrips({k: (lambda lib=lib: lib) for k, lib in libs.items()},
                                   with_lib)
    return res


def roundtrips(libs, with_lib, n: int = 5) -> dict:
    """Median compress/decompress walls of the smoke's three requests
    through the device coder, bf16 and f32, per build, in turns."""
    x = torch.from_numpy(load_image(IMAGE)).cuda()
    requests = [x, x.flip(2).contiguous(), x.flip(1).contiguous()]
    codecs = {name: HyresCodec.from_artifact(ARTIFACT, compute_dtype=dt, device="cuda",
                                             coder="device")
              for name, dt in (("bf16", torch.bfloat16), ("f32", None))}
    out, frames = {}, {}
    for turn in ("baseline", "this", "this", "baseline"):
        lib = libs[turn]()
        for name, codec in codecs.items():
            def run():
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
                return walls, comp
            with_lib(lib, lambda: codec.decompress(codec.compress(x)))  # warm-up
            walls, comp = with_lib(lib, run)
            key = f"{name}/{turn}"
            frames.setdefault(name, comp["strings"])
            if comp["strings"] != frames[name]:
                raise SystemExit(f"{name}: the builds' frames differ")
            c = sorted(w[0] for w in walls)[len(walls) // 2]
            d = sorted(w[1] for w in walls)[len(walls) // 2]
            out.setdefault(key, []).append({"compress_ms": c, "decompress_ms": d})
            print(f"{turn:8s} device coder {name}: median of {len(walls)} requests compress "
                  f"{c:.2f} ms, decompress {d:.2f} ms", flush=True)
    return out


def split() -> dict:
    """clock64 spans a step: K3 and K4 on the anchor y half, K5 on z."""
    jobs, decodes = request_planes()
    job = jobs[1]
    p = job.plane
    B, T, lanes = p.start.shape
    (want_s, want_st, want_n), = krans.encode_planes([p])
    lib = build(SPLIT / "warp.cu", "hyres_rans_split_warp")
    lib.split_names.restype = ctypes.c_char_p
    lib.split_names.argtypes = [ctypes.c_int]
    lib.split_encode.argtypes = [ctypes.POINTER(krans._EncPlaneC), ctypes.c_int, ctypes.c_void_p]
    lib.split_decode.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    res = {}
    for kernel, kind in enumerate(("K3", "K4", "K5")):
        prof = torch.zeros(64, dtype=torch.int64, device="cuda")
        if kind == "K3":
            s = torch.empty((1, p.cap), dtype=torch.int16, device="cuda")
            st = torch.empty((1, lanes), dtype=torch.int32, device="cuda")
            nr = torch.empty((1,), dtype=torch.int32, device="cuda")
            d = (krans._EncPlaneC * 1)()
            d[0].start, d[0].freq, d[0].low, d[0].ks = (
                getattr(p, f).data_ptr() for f in ("start", "freq", "low", "ks"))
            work = torch.empty(krans._lib().hyk_rans_encode_work(T, lanes, p.cap),
                               dtype=torch.uint8, device="cuda")
            d[0].stream, d[0].states, d[0].n_renorm = s.data_ptr(), st.data_ptr(), nr.data_ptr()
            d[0].work = work.data_ptr()
            d[0].T, d[0].lanes, d[0].cap, d[0].B = T, lanes, p.cap, 1
            rc = lib.split_encode(d, 1, prof.data_ptr())
            torch.cuda.synchronize()
            ok = torch.equal(s, want_s) and torch.equal(st, want_st) and torch.equal(nr, want_n)
            plane, steps = "anchor", T
        else:
            plane = "anchor" if kind == "K4" else "z"
            kern, args, steps = decodes[plane]
            idx, bounds, aux, stream, states, _, _ = args
            want_sym = kern(*args)
            o = torch.empty((1, idx.shape[1] * idx.shape[2]), dtype=torch.int32, device="cuda")
            rc = lib.split_decode(int(kind == "K4"), idx.data_ptr(), bounds.data_ptr(),
                                  aux.data_ptr(), aux.shape[1] if aux.dim() == 2 else 1,
                                  bounds.shape[0], bounds.shape[1], stream.data_ptr(),
                                  stream.shape[1], states.data_ptr(), o.data_ptr(), 1, steps,
                                  idx.shape[2], prof.data_ptr())
            torch.cuda.synchronize()
            # the split build leaves escapes unsubstituted
            ok = float((o == want_sym).float().mean()) > 0.999
        if rc != 0 or not ok:
            raise SystemExit(f"split {kind}: rc {rc}, outputs differ from the kernel's")
        names = lib.split_names(kernel).decode().split(",")
        pr = prof.cpu().numpy().astype(np.float64)
        nthr = max(pr[32], 1.0)
        spans = {nm: {"mean": pr[i] / nthr / steps, "thread0": pr[16 + i] / steps}
                 for i, nm in enumerate(names) if nm}
        if "loop ns" in spans:  # globaltimer over the loop: the SM clock it ran at
            spans["SM MHz"] = {k: spans["loop total"][k] / spans["loop ns"][k] * 1e3
                               for k in ("mean", "thread0")}
        res[kind] = spans
        print(f"== {kind} ({plane}, T {steps}): cycles a step", flush=True)
        for nm, v in spans.items():
            print(f"   {nm:36s} {v['mean']:9.1f} (thread 0: {v['thread0']:9.1f})", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="root of another checkout to time against")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true", help="clock64 split of a K3-K5 step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rans_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    out = {"nvidia_smi": smi}
    if args.split:
        out["split"] = split()
    if args.baseline:
        out["ab"] = ab(args.baseline, args.reps)
    out["seconds"] = time.perf_counter() - t0
    (ROOT / "smoke_out").mkdir(exist_ok=True)
    (ROOT / "smoke_out" / "torch_rans_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
