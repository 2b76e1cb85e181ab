"""The least time of the window attentions (kernel K7's work) of a cell's
calls, counted on the reference's own attention calls.

``blocks`` runs the reference's compress and decompress of an h x w image
on meta tensors and records each call of its window attention
(``wmsa``): (tokens, channels, head width, window, shifted). A block's
least time is the larger of its least bytes at the peak bandwidth (qkv
read once, the output written once, the gathered bias table read once;
float32) and its matrix products (QK^T and PV, 4 tokens p^2 C operations)
at the FP32 peak.

``bind`` keeps the configuration, its reference module and its weights'
shapes for the readers of ``window_attn_roofline.*``; a configuration
whose weights module calls it (``configs/tcm-n128-m320.py``) is one whose
calls run K7. The same module's public decompress calls ``mark`` after
each call, which keeps the program's ``WINDOW_ATTN_STATS`` launches: the
profiled slice follows the window's last decompress and calls the codec's
halves, never that decompress, so the launches since the last mark are the
slice's (``slice_launches``). Both stand in for what the harness does not
record yet: the configuration in the run's record, and the launches of
each kernel in the trace.
"""

from __future__ import annotations

import re

import torch

from . import _meta

FLOAT_BYTES = 4
KERNEL = re.compile(r"\bwindow_attn_kernel<")
_BOUND: dict = {}


def bind(cfg: dict, refmod, W: dict) -> None:
    _BOUND.update(cfg=cfg, refmod=refmod,
                  W={k: torch.empty(v.shape, device="meta") for k, v in W.items()})


def blocks(cfg: dict, refmod, W: dict, h: int, w: int) -> dict:
    """{"compress": [...], "decompress": [...]}: the reference's attention
    calls in order, each (tokens, channels, head width, window, shifted)."""
    ref = refmod.Reference(cfg, _meta(W))
    calls: list = []
    inner = refmod.wmsa

    def recorded(Wd, name, x, d, p, shifted):
        B, H, Wx, C = x.shape
        calls.append((B * H * Wx, C, d, p, bool(shifted)))
        return inner(Wd, name, x, d, p, shifted)

    refmod.wmsa = recorded
    try:
        with torch.no_grad():
            e = ref.encode(torch.empty((1, h, w, 3), device="meta"))
            n = len(calls)
            ref.decode(e["symbols"], h, w)
    finally:
        refmod.wmsa = inner
    return {"compress": calls[:n], "decompress": calls[n:]}


def least_seconds(block: tuple, peak: dict) -> float:
    tokens, C, d, p, _ = block
    nbytes = FLOAT_BYTES * (4 * tokens * C + (C // d) * p ** 4)
    flops = 4 * tokens * p * p * C
    return max(nbytes / peak["hbm_bytes"], flops / peak["fp32_flops"])


def program_launches():
    """The program's K7 launches so far; None where it has no K7."""
    try:
        from hyres_tpu_torch.kernels.window_attn import WINDOW_ATTN_STATS
    except ImportError:
        return None
    return WINDOW_ATTN_STATS["launches"]


def mark() -> None:
    _BOUND["mark"] = program_launches()


def slice_launches():
    """K7's launches since the last ``mark``: the profiled slice's."""
    now, then = program_launches(), _BOUND.get("mark")
    return None if now is None or then is None else now - then


def roofline(run: dict, call: str):
    """Percent of the least time: the profiled ``call``s' attentions at
    their bound, over the device time of K7 inside them. None where no
    configuration is bound, the window's requests have more than one shape,
    or K7's launches in the slice (``slice_launches``) differ from the
    reference's attention calls times the profiled calls (a path that skips
    an attention)."""
    spans = (run.get("trace") or {}).get("spans", {})
    shapes = set(map(tuple, run.get("shapes") or ()))
    if "cfg" not in _BOUND or len(shapes) != 1 or not spans.get(call):
        return None
    h, w = next(iter(shapes))
    b = blocks(_BOUND["cfg"], _BOUND["refmod"], _BOUND["W"], h, w)
    expected = sum(len(spans.get(c, ())) * len(b[c]) for c in ("compress", "decompress"))
    if slice_launches() != expected:
        return None
    t = sum(d for s in spans[call] for k, d in s["kernels"].items() if KERNEL.search(k))
    if t <= 0:
        return None
    least = len(spans[call]) * sum(least_seconds(blk, run["peak"]) for blk in b[call])
    return 100.0 * least / t
