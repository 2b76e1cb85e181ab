"""The program's own spans in a profiled slice.

The port marks its layers with ``hyres.*`` ranges
(``hyres_tpu_torch/utils/trace.py``) while a profiler runs. ``read`` takes
the profiler's events and gives, for each program root (``ROOTS``), how
many times each program span opened under it and the device's idle time
inside it, each stretch given to the group of the innermost program span
open then: ``model`` for ``model.*``, ``coder`` for ``coder.*``, ``optim``
for ``optim.*`` and ``host`` for the rest (``jfif.*``, ``dp.*`` and the
roots' own glue). It also gives, for each benchmark span (``pb.*``,
``lib/trace.py``), the idle time inside it and the part of that under a
program span: the spans' coverage.

Device activity is counted as ``lib/trace.py read_profile`` counts it:
the card's kernels, copies and sets, not the ranges that annotations draw
on the device's timeline. The functions below the reader turn its output
into the per-layer numbers: idle milliseconds per call by group, and pulls
per compress.
"""

from __future__ import annotations

from collections import defaultdict

from .trace import _merge

ROOTS = ("compress.dispatch", "compress.finish", "decompress.dispatch",
         "decompress.wait", "train.step")
COMPRESS = ("compress.dispatch", "compress.finish")
DECOMPRESS = ("decompress.dispatch", "decompress.wait")
PREFIX = "hyres."


def group(name: str) -> str:
    """The group of a program span's name (without ``hyres.``)."""
    head = name.split(".", 1)[0]
    return head if head in ("model", "coder", "optim") else "host"


def _device(e) -> bool:
    kind = getattr(e.device_type, "name", str(e.device_type))
    return kind == "CUDA" and not (getattr(e, "is_user_annotation", False)
                                   or e.name.startswith(("pb.", PREFIX)))


def _host_range(e, prefix: str) -> bool:
    kind = getattr(e.device_type, "name", str(e.device_type))
    return kind == "CPU" and e.name.startswith(prefix)


def read(events) -> dict:
    """-> {"roots": {root: {"n", "spans": {name: count}, "idle_s": {group:
    s}, "idle_by_span": {innermost span's name: s}}}, "bench": {pb name:
    {"idle_s", "covered_s"}}}; names without their prefixes, times in
    seconds. Spans outside any root are counted under the root ``None``."""
    spans = []  # (start, end, name, is_program)
    busy = []
    for e in events:
        tr = e.time_range
        if _device(e):
            busy.append((tr.start, tr.end))
        elif _host_range(e, PREFIX):
            spans.append((tr.start, tr.end, e.name[len(PREFIX):], True))
        elif _host_range(e, "pb."):
            spans.append((tr.start, tr.end, e.name[3:], False))
    # a sweep over every edge: at one instant ends go before starts, so that
    # back-to-back spans do not overlap, and the longer of two spans that
    # start together opens first, as the outer one
    edges = []
    for i, (s, e, _, _) in enumerate(spans):
        edges += [(s, 1, s - e, i), (e, 0, 0, i)]
    for a, b in _merge(busy):
        edges += [(a, 1, 0, -1), (b, 0, 0, -1)]
    edges.sort()
    roots = defaultdict(lambda: {"n": 0, "spans": defaultdict(int),
                                 "idle_s": defaultdict(float),
                                 "idle_by_span": defaultdict(float)})
    bench = defaultdict(lambda: {"idle_s": 0.0, "covered_s": 0.0})
    open_, on_device, prev = [], False, None
    for t, starts, _, i in edges:
        if prev is not None and t > prev and not on_device and open_:
            dt = (t - prev) / 1e6
            prog = [j for j in open_ if spans[j][3]]
            if prog:
                root = next((spans[j][2] for j in prog if spans[j][2] in ROOTS), None)
                inner = spans[prog[-1]][2]
                roots[root]["idle_s"][group(inner)] += dt
                roots[root]["idle_by_span"][inner] += dt
            for name in {spans[j][2] for j in open_ if not spans[j][3]}:
                bench[name]["idle_s"] += dt
                if prog:
                    bench[name]["covered_s"] += dt
        if i < 0:
            on_device = bool(starts)
        elif starts:
            open_.append(i)
            _, _, name, prog = spans[i]
            if prog:
                root = next((spans[j][2] for j in open_
                             if spans[j][3] and spans[j][2] in ROOTS), None)
                roots[root]["spans"][name] += 1
                if name == root and name in ROOTS:
                    roots[root]["n"] += 1
        else:
            open_.remove(i)
        prev = t
    return {"roots": {r: {k: (dict(x) if isinstance(x, dict) else x) for k, x in v.items()}
                      for r, v in roots.items()},
            "bench": {k: dict(v) for k, v in bench.items()}}


def _calls(program: dict, root: str) -> int:
    return (program.get("roots") or {}).get(root, {}).get("n", 0)


def idle_ms(program: dict, roots, groups, per: str):
    """Idle ms under ``roots`` attributed to ``groups``, per ``per`` root
    span; None where no ``per`` span opened."""
    n = _calls(program, per)
    if not n:
        return None
    r = program["roots"]
    return 1e3 * sum(r.get(k, {}).get("idle_s", {}).get(g, 0.0)
                     for k in roots for g in groups) / n


def pulls_per_compress(program: dict):
    """``coder.pull_wait`` spans under the compress roots per compress."""
    n = _calls(program, "compress.dispatch")
    if not n:
        return None
    r = program["roots"]
    return sum(r.get(k, {}).get("spans", {}).get("coder.pull_wait", 0) for k in COMPRESS) / n


def coverage(program: dict, names) -> dict:
    """Per benchmark span name: idle seconds inside it, the part under a
    program span, and that part as a share in %."""
    out = {}
    for n in names:
        b = (program.get("bench") or {}).get(n)
        if b:
            share = 100.0 * b["covered_s"] / b["idle_s"] if b["idle_s"] > 0 else None
            out[n] = {**b, "covered_pct": share}
    return out


ALL = COMPRESS + DECOMPRESS
# the per-layer numbers by the loop a cell drives: name -> reader
METRICS = {
    "serve_seq": {
        "idle_ms.compress.model": lambda p: idle_ms(p, COMPRESS, ("model",), "compress.dispatch"),
        "idle_ms.compress.coder": lambda p: idle_ms(p, COMPRESS, ("coder",), "compress.dispatch"),
        "idle_ms.compress.host": lambda p: idle_ms(p, COMPRESS, ("host",), "compress.dispatch"),
        "idle_ms.decompress.model": lambda p: idle_ms(p, DECOMPRESS, ("model",),
                                                      "decompress.dispatch"),
        "idle_ms.decompress.coder": lambda p: idle_ms(p, DECOMPRESS, ("coder",),
                                                      "decompress.dispatch"),
        "idle_ms.decompress.host": lambda p: idle_ms(p, DECOMPRESS, ("host",),
                                                     "decompress.dispatch"),
        "pulls_per_compress": pulls_per_compress,
    },
    "serve_stream": {
        "idle_ms.stream.model": lambda p: idle_ms(p, ALL, ("model",), "compress.dispatch"),
        "idle_ms.stream.coder": lambda p: idle_ms(p, ALL, ("coder",), "compress.dispatch"),
        "idle_ms.stream.host": lambda p: idle_ms(p, ALL, ("host",), "compress.dispatch"),
    },
    "train": {
        "idle_ms.train.model": lambda p: idle_ms(p, ("train.step",), ("model",), "train.step"),
        "idle_ms.train.optimizer": lambda p: idle_ms(p, ("train.step",), ("optim",),
                                                     "train.step"),
    },
}
# the benchmark spans that enclose a loop's profiled slice
ENCLOSING = {"serve_seq": ("compress", "decompress"), "serve_stream": ("stream",),
             "train": ("train",)}
