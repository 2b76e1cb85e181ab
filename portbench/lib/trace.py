"""Spans and the profiled slice of a ``--trace 1`` run.

The benchmark opens a span around each call it makes into a layer of the
program (``Spans``); inside the profiled slice each span is also a
``torch.profiler.record_function`` range, so its interval lies on the
profiler's clock beside the device's kernels. ``read_profile`` turns the
trace into what the metric readers take: per span its wall, the device
time inside it and the time of each kernel inside it; the slice's busy
seconds (the union of device activity); the top device operations; and
the device's idle time, each stretch labelled by the innermost span open
in it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    """Span names opened around calls into the program: a
    ``record_function`` range inside the profiled slice, nothing outside."""

    def __init__(self):
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.profiling:
            yield
            return
        import torch

        with torch.profiler.record_function("pb." + name):
            yield


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, s, e) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


def profile(fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA) and synchronise;
    returns (profiler, host seconds of the slice)."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
    return prof, wall


def read_profile(prof, wall_s: float) -> dict:
    """-> {"spans": {name: [{"wall", "busy", "kernels": {kernel: s}}]},
    "busy_s", "window_s", "device_ops": [[name, s]], "idle_gaps": [[label,
    s]]}; times in seconds. The slice is the first span's start to the
    last span's end. Device time counts the card's own activity (kernels,
    copies, sets), not the ranges that annotations such as an optimizer's
    ``step`` draw on the device's timeline."""
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        kind = getattr(e.device_type, "name", str(e.device_type))
        if kind == "CUDA" and not (getattr(e, "is_user_annotation", False)
                                   or e.name.startswith("pb.")):
            dev.append((tr.start, tr.end, e.name))  # kernels, copies and sets
        elif kind == "CPU" and e.name.startswith("pb."):
            spans.append((tr.start, tr.end, e.name[3:]))
    merged = _merge([(s, e) for s, e, _ in dev])
    out = {"spans": defaultdict(list), "window_s": wall_s}
    for s, e, name in spans:
        kernels = defaultdict(float)
        for ks, ke, kn in dev:
            if ks >= s and ke <= e:
                kernels[kn] += (ke - ks) / 1e6
        out["spans"][name].append({"wall": (e - s) / 1e6, "busy": _overlap(merged, s, e) / 1e6,
                                   "kernels": dict(kernels)})
    out["spans"] = dict(out["spans"])
    if spans:
        lo, hi = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
        out["busy_s"] = _overlap(merged, lo, hi) / 1e6
    else:
        lo = hi = 0.0
        out["busy_s"] = 0.0
    ops = defaultdict(float)
    for s, e, n in dev:
        ops[n[:160]] += (e - s) / 1e6
    out["device_ops"] = [[n, t] for n, t in sorted(ops.items(), key=lambda kv: -kv[1])[:10]]
    gaps = defaultdict(float)
    clipped = [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]
    edges = [lo] + [v for iv in clipped for v in iv] + [hi]
    cuts = sorted({v for s_, e_, _ in spans for v in (s_, e_)})
    for a, b in zip(edges[0::2], edges[1::2]):  # each gap, split where a span opens or closes
        pts = [a] + [v for v in cuts if a < v < b] + [b]
        for u, v in zip(pts, pts[1:]):
            mid = (u + v) / 2
            open_ = [(s_, e_, n) for s_, e_, n in spans if s_ <= mid <= e_]
            label = min(open_, key=lambda t: t[1] - t[0])[2] if open_ else "between calls"
            gaps[label] += (v - u) / 1e6
    out["idle_gaps"] = [[n, t] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
    return out
