"""The serving protocol of the entropy-coded codecs, written once.

Counterpart of ``hyres_tpu/models/base.py``: the coder choice, baked CDF
table state with ``update``/``install_tables``/``_require_tables`` (which
also build the device coder), the factorized-prior (z) plane coding
``_eb_encode``/``_eb_decode`` of the host coder, and the protocol that
every codec family runs.

A family supplies its stages and, for the protocol:

* ``_chain(z_sym, code, y=None)``: its stages in the decoder's order, which
  both sides of the channel run (the bit-exactness invariant of
  ``models/codec.py``). Each y plane is coded through ``code(coding,
  sym)``, where ``coding`` is the plane's scale indexes (a mixture's: its
  K6 rows) and ``sym`` the encoder's symbols of its own ``y``, None on the
  decoder side; ``code`` returns the plane's symbols. ``_synthesis`` takes
  what the chain returns;
* ``_y_planes(shape)``: each y plane's packed (H, W, C), for unframing;
* ``Z_LAST``: the order of its K3 jobs, which is also the order of its
  pull and of its decode upload (ELIC's and TCM's y planes come first and
  z last; the other families put z first). The JAX comparisons pin it;
* ``PAD``: the multiple that the input's height and width pad to (64; TCM
  128, for whole attention windows).

``CodecBase`` supplies the three ``code`` callbacks (encode: record the
plane; host decode; device decode) and the rest. ``compress`` is
``_compress_dispatch``, which only enqueues work on the card (the front,
the chain, one K3 launch for every plane and the pull of the sliced wire,
``models/codec.py pull_encs_dispatch``), then ``_compress_finish``, which
waits on the pull's event and frames every plane; the host coder codes in
the finish. A plane over its stream cap or escape list re-codes the whole
request with the host coder, counted in ``WIRE_STATS``, so formats never
mix in a payload; a mixture plane has no host coding and raises.
``decompress`` is ``_dec_dispatch_from_comp``, which reads which coder
framed the payload, queues the device path (one unframe and ONE upload of
every plane, K5 for z, then the chain with a y plane's decode at each of
its steps, no host synchronisation) or runs the host path, and the
synthesis, and returns an event recorded after the last stage; then a
wait on that event. ``inference_stream`` interleaves the halves of
neighbouring requests. On a card, the device coder's dispatch half is one
CUDA graph a request key once the request's shape has its pull marks
(``models/graphs.py``): the front, the chain, K3 and the pull's pack
replay in one launch. The root spans ``compress.dispatch``,
``compress.finish``, ``decompress.dispatch`` and ``decompress.wait`` open
here.

HyRES extends the protocol through three hooks: ``_front`` (its JPEG base
layer, with the coefficients riding the pull), ``_assemble`` (its JFIF
bytes, after framing) and ``_tail`` (the JFIF parse, the coefficient
upload and the decode tail, once the chain and g_s are queued).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..coding import device_rans
from ..entropy import (CdfTables, build_bottleneck_tables, build_gaussian_tables,
                       build_indexes, get_scale_table, narrow_symbols_i16)
from ..jpeg.core import pad_to_multiple
from ..utils.device import record_event, resolve_device, wait_event
from ..utils.trace import span


class CodecBase:
    """Holds the model, its device and the baked tables; serves requests."""

    # the K3 jobs, the pull and the decode upload put z after the y planes
    Z_LAST = False
    # the input's height and width pad to a multiple of this
    PAD = 64

    def __init__(self, model, clamp: Tuple[float, float] | None = (0.0, 1.0),
                 coder: str = "host", device="cuda"):
        """coder: "host" = C++ rANS with per-chunk framing (rate-optimal, but
        a host synchronisation between decode stages); "device" = the
        lane-parallel rANS coder on the card (``coding/device_rans.py``,
        the JAX package's "tpu" coder): the decode chain runs without a
        host synchronisation, at ~4 bytes a lane of extra stream."""
        if coder not in ("host", "device"):
            raise ValueError(f"unknown coder {coder!r} (choose 'host' or "
                             "'device')")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.clamp = clamp
        self.coder = coder
        self.scale_table = get_scale_table()
        self._scale_table_t = torch.from_numpy(self.scale_table).to(self.device)
        self.gauss_tables: CdfTables | None = None
        self.eb_tables: CdfTables | None = None
        self.device_coder = None

    def _after_tables(self) -> None:
        """(Re)build the device coder when the tables change; the dispatch
        graphs, which read the old coder's tables, go."""
        self.__dict__.pop("_graph_cache", None)
        if self.coder == "device":
            self.device_coder = _coders.DevicePlaneCoder(self.eb_tables, self.scale_table,
                                                         self.device)

    def _eb_param_dict(self) -> dict:
        return self.model.entropy_bottleneck.param_dict()

    def update(self, scale_table=None, force: bool = False) -> bool:
        """Bake the Gaussian scale-table CDFs and the factorized-prior CDFs.

        The scale table is bound at construction (it maps scales to indexes
        on both sides of the channel), so a different table here would
        desync the indexes from the baked CDFs: it raises instead."""
        if scale_table is not None:
            st = np.asarray(scale_table, np.float32)
            if st.shape != self.scale_table.shape or not np.allclose(
                    st, self.scale_table):
                raise ValueError(
                    "custom scale tables must be passed to the codec "
                    "constructor (the stages bind the table); update() only "
                    "re-bakes CDFs for the bound table")
        if self.gauss_tables is not None and not force:
            return False
        self.gauss_tables = build_gaussian_tables(self.scale_table)
        self.eb_tables = build_bottleneck_tables(self._eb_param_dict())
        self._after_tables()
        return True

    def install_tables(self, tables: dict) -> None:
        """Install pre-baked CDF tables (an artifact's ``tables`` tree)."""
        def mk(d):
            return CdfTables(
                quantized_cdf=np.asarray(d["quantized_cdf"], np.int32),
                cdf_length=np.asarray(d["cdf_length"], np.int32),
                offset=np.asarray(d["offset"], np.int32))

        self.gauss_tables = mk(tables["gaussian"])
        self.eb_tables = mk(tables["bottleneck"])
        self._after_tables()

    def _require_tables(self):
        if self.gauss_tables is None or self.eb_tables is None:
            raise RuntimeError("call update() or install_tables() before "
                               "compress/decompress")

    def _indexes(self, scales_packed: torch.Tensor) -> torch.Tensor:
        """Packed scales -> uint8 scale-table indexes."""
        return build_indexes(scales_packed, self._scale_table_t).to(torch.uint8)

    # -- the host coder's planes -------------------------------------------

    def _eb_encode(self, z_sym: np.ndarray) -> List[bytes]:
        C = z_sym.shape[-1]
        idx = np.ascontiguousarray(
            np.broadcast_to(np.arange(C, dtype=np.int32), z_sym.shape))
        return _coders._encode_planes(z_sym, idx, self.eb_tables)

    def _eb_decode(self, strings: Sequence[bytes],
                   shape: Tuple[int, int]) -> np.ndarray:
        C = self.eb_tables.cdf_length.shape[0]
        idx = np.ascontiguousarray(np.broadcast_to(
            np.arange(C, dtype=np.int32), (len(strings), *shape, C)))
        return _coders._decode_planes(strings, idx, self.eb_tables)

    def _host_y_encode(self, planes) -> list:
        """[(symbols, indexes)] numpy of the y planes -> their host-coder
        strings: a frame list a plane."""
        return [_coders._encode_planes(s, i, self.gauss_tables) for s, i in planes]

    def _host_y_reader(self, y_strings):
        """-> ``read(indexes)``, which gives the next y plane's symbols."""
        planes = iter(y_strings)
        return lambda idx: _coders._decode_planes(next(planes), idx, self.gauss_tables)

    def _framed_by_device(self, strings) -> bool:
        """Whether the device coder framed a payload (its z frames say)."""
        return bool(strings[1]) and device_rans.is_device_frame(strings[1][0])

    # -- the family's order of planes on the device coder --------------------

    def device_jobs(self, z_sym, planes) -> List[device_rans.PlaneJob]:
        """The K3 jobs of ``latents``' z and y planes, built in the family's
        order."""
        dc = self.device_coder
        if self.Z_LAST:
            return [dc.job(s, c) for s, c in planes] + [dc.eb_job(z_sym)]
        return [dc.eb_job(z_sym)] + [dc.job(s, c) for s, c in planes]

    def _in_k3_order(self, z, ys: list) -> list:
        return ys + [z] if self.Z_LAST else [z] + ys

    def _split_z(self, seq: list):
        """A list in K3 order -> (z's entry, the y planes' entries)."""
        return (seq[-1], seq[:-1]) if self.Z_LAST else (seq[0], seq[1:])

    # -- hooks that HyRES extends ------------------------------------------------

    def _front(self, x: torch.Tensor):
        """NHWC float32 x on the device -> (y, z symbols, the pull's extra
        (B, ...) tensor or None, what ``_assemble`` takes)."""
        y, z_sym = self.enc_analysis(pad_to_multiple(x, self.PAD))
        return y, z_sym, None, None

    def _assemble(self, out: Dict, extra, ctx) -> None:
        """Completes a compress's output from the front's extra (numpy) and
        context, after framing."""

    def _tail(self, x_hat: torch.Tensor, comp: Dict, queued: bool) -> torch.Tensor:
        """The decode after the synthesis; ``queued``: the decode chain was
        queued on the device."""
        return x_hat

    # -- compress ----------------------------------------------------------------

    def latents(self, x: torch.Tensor):
        """NHWC x -> (z symbols, [(symbols, coding)] of the y planes in the
        chain's order)."""
        return self._encode(x)[:2]

    def _encode(self, x: torch.Tensor):
        y, z_sym, extra, ctx = self._front(x)
        planes = []

        def code(coding, sym):
            planes.append((sym, coding))
            return sym

        self._chain(z_sym, code, y)
        return z_sym, planes, extra, ctx

    def compress(self, x: torch.Tensor) -> Dict:
        """NHWC [0,1] batch -> {"strings", "shape", "size", "symbols",
        "time"} (HyRES adds "jpeg_buffers")."""
        return self._compress_finish(self._compress_dispatch(x))

    def _compress_dispatch(self, x: torch.Tensor):
        """Async half of compress: the front, the chain and, under the
        device coder, one K3 launch for every plane and the pull, enqueued
        without a wait. On a card, a device-coder request whose shape has
        marks replays a CUDA graph of all of it but the pull's copy
        (``models/graphs.py``)."""
        self._require_tables()
        start = time.perf_counter()
        with span("compress.dispatch"):
            size = (int(x.shape[1]), int(x.shape[2]))
            key = _graphs.graph_key(x)
            x = x.to(self.device, torch.float32)
            graphs = self._dispatch_graphs()
            cap_state = self.__dict__.setdefault("_enc_cap_state", {})
            replayed = None if graphs is None else graphs(key, x, cap_state)
            (z_sym, planes, extra, encs), ctx, blob = replayed or self._device_half(x)
            pull = None
            if encs is not None:
                if replayed is None:
                    _coders.WIRE_STATS["eager_dispatches"] += 1
                    if graphs is not None:
                        graphs.seen(key, _coders.pull_signature(encs, extra))
                pull = _coders.pull_encs_dispatch(encs, extra, cap_state, blob)
            return pull, z_sym, planes, extra, ctx, size, start

    def _device_half(self, x: torch.Tensor, spec=None):
        """The dispatch's device work on NHWC float32 ``x`` -> ((z symbols,
        [(symbols, coding)] of the y planes, the front's extra, K3's outputs
        under the device coder or None), what ``_assemble`` takes, the pull's
        blob packed for the speculative plan ``spec`` or None)."""
        z_sym, planes, extra, ctx = self._encode(x)
        encs = blob = None
        if self.device_coder is not None:
            with span("coder.encode"):
                encs = device_rans.encode(self.device_jobs(z_sym, planes))
            if spec is not None:
                with span("coder.pull"):
                    blob = _coders.pack_speculative(encs, extra, spec)
        return (z_sym, planes, extra, encs), ctx, blob

    def _dispatch_graphs(self):
        """The codec's dispatch graphs; None off the card or under the host
        coder."""
        if self.device_coder is None or not _graphs.engaged(self.device):
            return None
        if "_graph_cache" not in self.__dict__:
            self._graph_cache = _graphs.DispatchGraphs(self._device_half)
        return self._graph_cache

    def _compress_finish(self, state) -> Dict:
        """Wait on the pull and frame every plane, or code the planes with
        the host coder: under the host coder, and for the whole request when
        a plane overflowed its stream cap or escape list."""
        pull, z_sym, planes, extra, ctx, size, start = state
        with span("compress.finish"):
            symbols = (z_sym, *(s for s, _ in planes))
            strings = None
            if pull is not None:
                try:
                    encs, extra_np = pull()
                    frames = [self.device_coder.frames_from_enc(e) for e in encs]
                except OverflowError as e:
                    if any(_coders.is_gmm_rows(c) for _, c in planes):
                        raise OverflowError(f"a mixture plane overflowed the device coder "
                                            f"({e}); mixtures have no host coder") from e
                    _coders.count_host_fallback(e)
                else:
                    z_frames, y_frames = self._split_z(frames)
                    strings = [y_frames, z_frames]
                    _coders.count_gmm_planes(planes, self._split_z(encs)[1])
            if strings is None:
                host = [_coders._host(t) for t in symbols]
                y_strings = self._host_y_encode(
                    [(s, _coders._host(c)) for s, (_, c) in zip(host[1:], planes)])
                strings = [y_strings, self._eb_encode(host[0])]
                extra_np = None if extra is None else _coders._host(extra)
                if pull is None:
                    symbols = tuple(host)
            out = {"strings": strings, "shape": (int(z_sym.shape[1]), int(z_sym.shape[2])),
                   "size": size, "symbols": symbols}
            self._assemble(out, extra_np, ctx)
        out["time"] = time.perf_counter() - start
        return out

    # -- decompress --------------------------------------------------------------

    def decompress(self, strings, shape: Tuple[int, int],
                   size: Tuple[int, int] | None = None) -> Dict:
        """-> {"x_hat" NHWC, "symbols" decoded, "time"}."""
        return self._wait(self._dec_dispatch_from_comp(
            {"strings": strings, "shape": shape, "size": size}))

    @staticmethod
    def _wait(dispatched) -> Dict:
        x_hat, symbols, start, done = dispatched
        with span("decompress.wait"):
            wait_event(done)
        return {"x_hat": x_hat, "symbols": symbols, "time": time.perf_counter() - start}

    def _dec_dispatch_from_comp(self, comp: Dict):
        """Async half of decompress: -> (x_hat, decoded symbols, start time,
        event after the last stage), without a wait. The device path
        queues its whole chain; the host coder synchronises between
        stages."""
        self._require_tables()
        start = time.perf_counter()
        with span("decompress.dispatch"):
            strings, size = comp["strings"], comp.get("size")
            on_device = self._framed_by_device(strings)
            if on_device and self.device_coder is None:
                raise ValueError("payload is framed by the device rANS coder; "
                                 "construct the codec with coder='device'")
            decode = self._decode_device if on_device else self._decode_host
            chained, symbols = decode(strings, comp["shape"])
            x_hat = self._tail(self._synthesis(chained), comp, on_device)
            if size is not None:
                x_hat = x_hat[:, : size[0], : size[1], :]
            return x_hat, symbols, start, record_event(self.device)

    def _decode_host(self, strings, shape):
        """z, then the chain with a host read of each y plane -> (what the
        chain returns, decoded symbols as numpy arrays)."""
        read = self._host_y_reader(strings[0])
        z_np = narrow_symbols_i16(self._eb_decode(strings[1], shape))
        syms = []

        def code(coding, _sym=None):
            syms.append(narrow_symbols_i16(read(_coders._host(coding))))
            return torch.from_numpy(syms[-1]).to(self.device)

        return self._chain(torch.from_numpy(z_np).to(self.device), code), (z_np, *syms)

    def _decode_device(self, strings, shape):
        """ONE unframe and upload of every plane, then K5 for z and the chain
        with a y plane's decode at each of its steps, no host
        synchronisation -> (what the chain returns, decoded symbols as
        tensors)."""
        dc = self.device_coder
        B = len(strings[1])
        zshape = (B, shape[0], shape[1], self.eb_tables.cdf_length.shape[0])
        yshapes = [(B, *p) for p in self._y_planes(shape)]
        unframed = [_coders.DevicePlaneCoder.unframe_batch(f, int(np.prod(s[1:])))
                    for f, s in self._in_k3_order((strings[1], zshape),
                                                  list(zip(strings[0], yshapes)))]
        if any(u is None for u in unframed):
            raise ValueError("mixed stream framing: the device coder framed this "
                             "payload's z, the host coder one of its planes")
        uz, uy = self._split_z(_coders.upload_frames(unframed, self.device))
        z_sym = dc.decode_eb(uz[2], uz[1], uz[3], uz[4], zshape, uz[0])
        syms = []

        def code(coding, _sym=None):
            k = len(syms)
            syms.append(dc.decode(uy[k], coding, yshapes[k]))
            return syms[-1]

        return self._chain(z_sym, code), (z_sym, *syms)

    # -- serving -----------------------------------------------------------------

    def inference_stream(self, xs: Sequence, depth: int = 2) -> List[Dict]:
        """Pipelined roundtrips over a list of NHWC batches.

        ``depth`` requests are in flight at once: request i's pull and host
        framing run while request i+1's device work executes, and the same
        for the decodes, whose final wait is an event recorded after that
        request's last stage. Outputs come in input order; each "time"
        spans its own dispatch to finish, so the spans of neighbours
        overlap and the wall clock over ``len(xs)`` is the figure of merit.

        Streams and reconstructions equal sequential ``inference`` calls
        bit for bit: the same ops run on the same inputs, only the host
        side interleaves differently.
        """
        depth = max(1, depth)
        comps: List[Dict] = []
        pend = deque()
        for x in xs:
            pend.append(self._compress_dispatch(x))
            if len(pend) >= depth:
                comps.append(self._compress_finish(pend.popleft()))
        while pend:
            comps.append(self._compress_finish(pend.popleft()))

        outs: List[Dict] = []

        def finish_dec(item):
            dispatched, comp = item
            dec = self._wait(dispatched)
            outs.append({
                "x_hat": dec["x_hat"],
                "symbols": dec["symbols"],
                "compressed": comp,
                "strings": comp["strings"],
                "shape": comp["shape"],
                "time": {"compression": comp["time"], "decompression": dec["time"],
                         "total": comp["time"] + dec["time"]},
            })

        dpend = deque()
        for comp in comps:
            dpend.append((self._dec_dispatch_from_comp(comp), comp))
            if len(dpend) >= depth:
                finish_dec(dpend.popleft())
        while dpend:
            finish_dec(dpend.popleft())
        return outs

    def inference(self, x) -> Dict:
        """One timed roundtrip (reference ``checkerboard.py:242-259``): a
        compress, then a decompress of its payload."""
        return self.inference_stream([x], depth=1)[0]


# the coders subclass CodecBase, so they are bound once both modules exist
from . import codec as _coders  # noqa: E402
from . import graphs as _graphs  # noqa: E402
