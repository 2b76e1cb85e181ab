"""CUDA graphs of the compress's dispatch half, one a request key.

For a request shape and a pull plan, the dispatch half of a compress
(``models/base.py CodecBase._compress_dispatch``) launches the same device
operations on the same shapes every time and reads nothing on the host:
the front (HyRES's K1, K2, g_a and h_a; the other families' analysis), the
chain's stages with their K6 rows, K3's jobs and its launch, and the pack
of the speculative pull (``models/codec.py pack_speculative``). Issued op
by op, those several hundred small operations take the host longer than
the card takes to run them. ``DispatchGraphs`` captures them once as a
CUDA graph and replays the graph for every later request of the same key.

The key (``graph_key``) is the request's batch, shape and dtype and the
speculative plan that the codec's marks give. A shape's first call has no
marks yet (a full-cap or a size pull) and runs op by op; it also warms
cuDNN's heuristics and autotuner, so nothing is tuned inside a capture.
Every later call replays the graph of its key, capturing it at the key's
first call; marks that move the plan make a new key. A codec keeps at most
``CAPACITY`` graphs, the least recently used going first.

A replay copies the request into the graph's input buffer, launches the
graph and then, in one copy, takes every tensor that leaves the call (the
symbols; the codings and the extra that the host-coder fallback reads;
the encoder outputs that a miss's re-pull reads) out of the graph's
memory, so that a request's outputs stay its own while the next request's
replay runs. The pull's blob is read from the graph's memory by the
device-to-host copy queued right behind the replay. The kernel counters
(``kernels/rans.py LAUNCHES`` and ``LAUNCH_SHAPES``, ``kernels/dct.py
LAUNCHES``, ``GMM_STATS``' rows, ``kernels/window_attn.py
WINDOW_ATTN_STATS``) advance at a replay by what the capture counted, so a
roundtrip reads the same launches either way.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, NamedTuple

import torch

from ..kernels import dct
from ..kernels import rans as krans
from ..kernels import window_attn as k7
from ..utils.trace import span
from . import codec as _coders

CAPACITY = 4  # graphs a codec keeps


def engaged(device: torch.device) -> bool:
    """Whether a device-coder codec on ``device`` graphs its dispatch."""
    return device.type == "cuda"


def graph_key(x: torch.Tensor, spec: _coders.Speculative | None = None) -> tuple:
    """The graph of request ``x`` under the speculative plan ``spec``: its
    batch, shape and dtype and the plan (None: the request's shape
    alone)."""
    return tuple(x.shape), x.dtype, spec


# -- the kernel counters a replay advances ----------------------------------


def _counters() -> list:
    return [krans.LAUNCHES, krans.LAUNCH_SHAPES, dct.LAUNCHES, _coders.GMM_STATS,
            k7.WINDOW_ATTN_STATS]


def _snapshot() -> List[dict]:
    return [dict(c) for c in _counters()]


def _restore(snap: List[dict]) -> None:
    for c, s in zip(_counters(), snap):
        c.clear()
        c.update(s)


def _delta(before: List[dict]) -> List[dict]:
    return [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
            for c, b in zip(_counters(), before)]


def _advance(delta: List[dict]) -> None:
    for c, d in zip(_counters(), delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + v


# -- the outputs that leave a call, in one buffer ------------------------------


class _Leaf(int):
    """A tensor's place among the leaves of a flattened output tree."""


def _flatten(tree, leaves: list):
    """``tree`` (tensors in nested lists, tuples and dicts) with each tensor
    replaced by its ``_Leaf``, appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


def _unflatten(tree, leaves: list):
    if isinstance(tree, _Leaf):
        return leaves[tree]
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return tree


def _pack(leaves: list):
    """-> (one uint8 tensor of the leaves' bytes, per leaf (start, bytes,
    dtype, shape)). The widest elements go first, so that every leaf
    starts at a multiple of its element size."""
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    layout: list = [None] * len(leaves)
    off = 0
    for i in order:
        t = leaves[i]
        n = t.numel() * t.element_size()
        layout[i] = (off, n, t.dtype, tuple(t.shape))
        off += n
    return torch.cat([leaves[i].reshape(-1).view(torch.uint8) for i in order]), layout


def _unpack(arena: torch.Tensor, layout: list) -> list:
    return [arena[o:o + n].view(dt).view(shape) for o, n, dt, shape in layout]


class _Static(NamedTuple):
    """What a capture leaves in the graph's memory and on the host."""

    arena: torch.Tensor     # the outputs that leave a call, packed
    layout: list
    tree: object            # the outputs' tree, its tensors as _Leaf
    ctx: object             # the family's host context for its finish
    blob: torch.Tensor      # the speculative pull's packed blob


def _static(out) -> _Static:
    tree, ctx, blob = out
    leaves: list = []
    flat = _flatten(tree, leaves)
    arena, layout = _pack(leaves)
    return _Static(arena, layout, flat, ctx, blob)


# -- capture ------------------------------------------------------------------

_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture(fn: Callable, device: torch.device):
    """``fn()`` captured as a CUDA graph on a side stream -> (the graph's
    replay, what ``fn`` returned). The side stream's first capture follows
    one uncounted op-by-op run of ``fn`` on it, for the state that
    libraries set up per stream (cuBLAS's workspace). The allocator's
    cached blocks go back to the device first: a capture allocates from
    the graph's own pool and cannot free them once it has begun."""
    torch.cuda.empty_cache()
    cur = torch.cuda.current_stream(device)
    side = _STREAMS.get(device)
    first = side is None
    if first:
        side = _STREAMS[device] = torch.cuda.Stream(device)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        if first:
            snap = _snapshot()
            fn()
            _restore(snap)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    cur.wait_stream(side)
    return graph.replay, out


class _Graph:
    """One key's captured dispatch: its input buffer, its replay, what it
    leaves in the graph's memory and the counters' advance a replay."""

    def __init__(self, body: Callable, x: torch.Tensor, spec: _coders.Speculative):
        with torch.inference_mode(False):
            self.x = torch.empty_like(x)
        self.x.copy_(x)
        before = _snapshot()
        self.replay, self.static = _capture(lambda: _static(body(self.x, spec)), x.device)
        self.delta = _delta(before)

    def run(self, x: torch.Tensor):
        """-> (the outputs' tree on memory of their own, host context, the
        blob in the graph's memory)."""
        self.x.copy_(x)
        self.replay()
        s = self.static
        return _unflatten(s.tree, _unpack(s.arena.clone(), s.layout)), s.ctx, s.blob


class DispatchGraphs:
    """A codec's graphs of its dispatch half. ``body(x, spec)`` is the
    dispatch's device work on the NHWC float32 request ``x`` -> (the tensors
    that leave the call, as a tree; the family's host context; the blob of
    the speculative plan ``spec``)."""

    def __init__(self, body: Callable):
        self.body = body
        self.sigs: Dict[tuple, tuple] = {}  # a shape's pull signature, from its first call
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()

    def seen(self, key: tuple, sig: tuple) -> None:
        """Note the pull signature of an op-by-op call of request ``key``
        (``graph_key`` without a plan)."""
        self.sigs[key] = sig

    def __call__(self, key: tuple, x: torch.Tensor, cap_state: dict):
        """Request ``key``'s dispatch from its graph, captured first if need
        be -> (tree, context, blob) as ``body`` gives them; None where the
        request runs op by op: its shape has no marks in ``cap_state``."""
        sig = self.sigs.get(key)
        st = None if sig is None else cap_state.get(sig)
        if st is None:
            return None
        full = key[:2] + (_coders.speculative_plan(sig, st),)
        g = self.graphs.get(full)
        if g is None:
            with span("graph.capture"):
                g = self.graphs[full] = _Graph(self.body, x, full[2])
            while len(self.graphs) > CAPACITY:
                self.graphs.popitem(last=False)
            _coders.WIRE_STATS["graph_captures"] += 1
        else:
            self.graphs.move_to_end(full)
            _advance(g.delta)
            _coders.WIRE_STATS["graph_replays"] += 1
        with span("graph.replay"):
            return g.run(x)
