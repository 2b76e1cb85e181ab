"""One run of one cell: set-up, the measured window, the profiled slice
(``--trace 1``), the metrics, the comparison with the reference, and the
result.

What a cell drives is its traffic's loop, ``loops/<loop>.py``, named by
the traffic file's ``loop`` key. Its ``Loop(ctx)`` gives ``setup()`` (the
program built and every shape warmed up), ``window(seconds)`` (the
window's record: ``window_s``, ``images`` and the host seconds of each
call under ``calls``), ``slice()`` (the profiled slice), ``work(record)``
(the reference's counts that the per-layer readers take), ``release()``
and ``check()`` (-> the numbers that decide ``correct``, each beside its
limit, and the requests that failed). Every metric, end to end or per
layer, is read from the record by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

from . import spec, traffic as T
from .trace import Spans, profile, read_profile

PEAK = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}  # H100 SXM data sheet


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Context:
    """What a loop gets: the cell and its files, the seed, the device, the
    reference's weights (``configs/<c>.py reference_weights``), the photo,
    the spans, and for the controls and tests a precision or a fault."""

    cell: spec.Cell
    seed: int
    device: object
    root: Path
    cfgmod: object
    refmod: object
    W: dict
    photos: T.Photos
    spans: Spans
    compute_dtype: object = None
    fault: object = None
    log: object = print
    elapsed: object = process_seconds


def host_state(cpu_before: float, window_s: float) -> str:
    """One line on what the host and the card were doing over the window:
    this process's CPU seconds per window second, and the card's clocks,
    temperature, power and throttle reasons as ``nvidia-smi`` reads them
    after the window."""
    parts = [f"cpu {(time.process_time() - cpu_before) / window_s:.3f} s/s"]
    try:
        q = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        parts.append("card " + smi.stdout.strip().replace("\n", " | "))
    except (OSError, subprocess.SubprocessError):
        pass
    return "; ".join(parts)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def read_metrics(entries, rec: dict) -> dict:
    """Each metric's reader on the run's record; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        v = spec.metric_module(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device_name: str = "cuda",
        compute_dtype=None, fault=None, log=print):
    """One run of ``cell``. Returns the result dict (the last line's keys,
    ``checks`` last). ``compute_dtype`` and ``fault`` serve the controls
    and tests: the program in another precision, or broken underneath."""
    import torch

    device = torch.device(device_name)
    cfg = cell.config
    cfgmod, refmod = spec.config_module(cfg), spec.reference_module(cfg)
    photos = T.Photos(cell.traffic, device)
    log(f"process up, photo on the device: {process_seconds():.2f} s")
    W = cfgmod.reference_weights(cfg, spec.ROOT, device, refmod)
    _sync(torch, device)
    log(f"weights made or read: {process_seconds():.2f} s")
    ctx = Context(cell, seed, device, spec.ROOT, cfgmod, refmod, W, photos, Spans(),
                  compute_dtype, fault, log)
    loop = spec.loop_module(cell.traffic["loop"]).Loop(ctx)
    loop.setup()
    _sync(torch, device)
    setup_s = process_seconds()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log(f"set-up {setup_s:.2f} s; window of {seconds} s")
    cpu0 = time.process_time()
    rec = loop.window(seconds)
    rec["setup_s"] = setup_s
    log(f"window: {rec['images']} images in {rec['window_s']:.3f} s; "
        + host_state(cpu0, rec["window_s"]))
    dev = device_info(torch, device)
    result = {"correct": False, "attempted": rec["images"], "failed": 0}
    breakdown = None
    if trace:
        ctx.spans.profiling = True
        prof, wall = profile(loop.slice)
        ctx.spans.profiling = False
        rec["trace"] = read_profile(prof, wall)
        rec["peak"] = PEAK
        loop.work(rec)
        metrics = read_metrics(cell.per_layer, rec)
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        breakdown = {"device_ops": rec["trace"]["device_ops"],
                     "idle_gaps": rec["trace"]["idle_gaps"]}
    else:
        metrics = read_metrics(cell.end_to_end, rec)
    # the program's state goes before the reference runs
    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, result["failed"] = loop.check()
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def loaded_jax() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level names."""
    banned = {"jax", "jaxlib", "flax", "hyres_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
