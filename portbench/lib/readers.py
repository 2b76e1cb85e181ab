"""Arithmetic shared by the per-layer metric readers (``metrics/*.py``).

Each reader takes the run's record: the window's ``window_s``,
``images``, ``setup_s`` and ``calls`` (host seconds of each call by its
name); in a traced run also ``trace`` (``lib/trace.py read_profile`` of
the profiled slice), ``peak``, and what the loop's ``work`` counted on
the reference (``counts/``): ``call_flops`` (the operations of each call
of the window, by the call's name), ``window_flops`` (of all the window's
completed work) and ``coder_bytes``. A reader that finds nothing to read
returns None, and the metric is left out of the line.
"""

from __future__ import annotations

import re

from . import stats


def idle_share(run: dict, span: str):
    """Percent of the span's wall in which no device work ran."""
    spans = (run.get("trace") or {}).get("spans", {}).get(span)
    if not spans:
        return None
    wall = sum(s["wall"] for s in spans)
    return 100.0 * (1.0 - sum(s["busy"] for s in spans) / wall) if wall > 0 else None


def p95_ms(run: dict, call: str):
    """The 95th percentile of every call's host seconds, in ms."""
    walls = run.get("calls", {}).get(call)
    return 1e3 * stats.percentile(walls, 95) if walls else None


def rate(run: dict):
    """Images completed over the whole window, per second."""
    return stats.rate(run["images"], run["window_s"]) if run.get("images") else None


def mfu_calls(run: dict, call: str):
    """Percent of the FP32 peak: the reference's operations of the window's
    calls, over the calls' summed host seconds."""
    walls = run.get("calls", {}).get(call)
    flops = run.get("call_flops", {}).get(call)
    if not walls or not flops:
        return None
    return 100.0 * sum(flops) / sum(walls) / run["peak"]["fp32_flops"]


def mfu_window(run: dict):
    """Percent of the FP32 peak: the reference's operations of the window's
    completed work over the whole window."""
    flops = run.get("window_flops")
    if not flops:
        return None
    return 100.0 * flops / run["window_s"] / run["peak"]["fp32_flops"]


def roofline(run: dict, span: str, kernel_pattern: str, bytes_key: str):
    """Percent of the bytes bound: the least bytes of the spans' requests at
    the peak bandwidth, over the device time of the kernels whose names
    match ``kernel_pattern`` inside those spans."""
    spans = (run.get("trace") or {}).get("spans", {}).get(span)
    nbytes = (run.get("coder_bytes") or {}).get(bytes_key)
    if not spans or not nbytes or len(nbytes) != len(spans):
        return None
    pat = re.compile(kernel_pattern)
    t = sum(d for s in spans for k, d in s["kernels"].items() if pat.search(k))
    if t <= 0:
        return None
    return 100.0 * sum(nbytes) / run["peak"]["hbm_bytes"] / t
