"""What the serving loops (``loops/serve_*.py``) share: the program's codec
called as a client calls it, timed on the host's clock, the warm-up, the
work counts of a traced run, and the comparison after the window.

A configuration's module (``configs/<c>.py``) gives ``serving(...)``, the
codec, and ``decompress(codec, compressed) -> (x_hat, decoded symbols)``,
its public decompress call (the families' signatures differ).
"""

from __future__ import annotations

import time

from .. import counts
from . import check, traffic as T


class Served:
    """What the window kept of a checked request."""

    def __init__(self, req, comp, dec_syms, x_hat):
        # copies, so that the program's own buffers go back to its allocator
        self.req = req
        self.payload = {k: v for k, v in comp.items() if k != "symbols"}
        self.coded = [s.clone() if hasattr(s, "clone") else s for s in comp["symbols"]]
        self.decoded = [s.clone() if hasattr(s, "clone") else s for s in dec_syms]
        self.x_hat = x_hat.clone()


def roundtrip(codec, decompress, x, spans):
    """(compress output, (x_hat, decoded symbols), compress s, decompress
    s): the public compress (the bytes on the host), then the public
    decompress of its payload (the reconstruction ready on the device),
    each timed around the whole call."""
    t0 = time.perf_counter()
    with spans("compress"):
        comp = codec.compress(x)
    t1 = time.perf_counter()
    with spans("decompress"):
        dec = decompress(codec, comp)
    t2 = time.perf_counter()
    return comp, dec, t1 - t0, t2 - t1


HALVES = ("_compress_dispatch", "_compress_finish", "_dec_dispatch_from_comp")


def traced_roundtrip(codec, decompress, x, spans):
    """A roundtrip of the profiled slice. Where the codec has the dispatch
    and finish halves that its public calls run, the slice calls them, so
    that the breakdown's idle gaps name the half they fall in; otherwise
    the public calls. Returns the compress output."""
    if not all(hasattr(codec, n) for n in HALVES):
        return roundtrip(codec, decompress, x, spans)[0]
    with spans("compress"):
        with spans("compress.dispatch"):
            st = codec._compress_dispatch(x)
        with spans("compress.finish"):
            comp = codec._compress_finish(st)
    with spans("decompress"):
        with spans("decompress.dispatch"):
            _, _, _, done = codec._dec_dispatch_from_comp(comp)
        with spans("decompress.wait"):
            if done is not None:
                done.synchronize()
    return comp


class ServingLoop:
    """Set-up, release and the comparison of a serving cell; a loop module
    subclasses it with its window and its profiled slice."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.cell.traffic
        self.reqs = T.requests(self.tr, ctx.photos)
        self.order = T.request_order(ctx.seed, self.reqs)
        self.every = int(self.tr["sample_every"])
        self.kept: list = []
        self.payloads: list = []  # the profiled slice's compress outputs

    def setup(self):
        c = self.ctx
        codec = c.cfgmod.serving(c.cell.config, c.root, c.device, c.W, c.compute_dtype)
        if c.fault is not None:
            codec = c.fault(codec)
        self.codec = codec
        c.log(f"program built: {c.elapsed():.2f} s")
        # every request of the mix compressed once: the wire's caps settle
        # at their high-water marks
        for r in self.reqs:
            codec.compress(c.photos.window(r))
        self.warm()

    def warm(self):
        """The loop's own warm-up, after every request was compressed once."""

    def keep(self, i, req, comp, syms, x_hat):
        if T.sampled(self.ctx.seed, i, self.every):
            self.kept.append(Served(req, comp, syms, x_hat))

    def flops(self) -> dict:
        """The reference's operations of a request, by its (h, w)."""
        c = self.ctx
        return {s: counts.serve_flops(c.cell.config, c.refmod, c.W, *s)
                for s in T.shapes(self.reqs)}

    def work(self, rec):
        """What the per-layer readers need beyond the window's record."""
        rec["coder_bytes"] = counts.coder_bytes(self.ctx.W, self.payloads)

    def release(self):
        del self.codec

    def check(self):
        c = self.ctx
        return check.serve(c.cell, c.refmod, c.W, self.kept, c.photos, c.device)
