"""Shared machinery of the entropy-coded codec wrappers.

Counterpart of ``hyres_tpu/models/base.py``: the coder choice, baked CDF
table state with ``update``/``install_tables``/``_require_tables`` (which
also build the device coder), the factorized-prior (z) plane coding
``_eb_encode``/``_eb_decode`` of the host coder, and the serving half:
the dispatch/finish hooks, ``inference_stream`` and ``inference``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..entropy import (CdfTables, build_bottleneck_tables,
                       build_gaussian_tables, get_scale_table)
from ..utils.device import resolve_device, wait_event
from ..utils.trace import span


class CodecBase:
    """Holds the model, its device and the baked tables."""

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
        """(Re)build the device coder when the tables change."""
        if self.coder == "device":
            from .codec import DevicePlaneCoder

            self.device_coder = DevicePlaneCoder(self.eb_tables, self.scale_table,
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

    # -- factorized-prior (z) coding ---------------------------------------

    def _eb_encode(self, z_sym: np.ndarray) -> List[bytes]:
        from .codec import _encode_planes

        C = z_sym.shape[-1]
        idx = np.ascontiguousarray(
            np.broadcast_to(np.arange(C, dtype=np.int32), z_sym.shape))
        return _encode_planes(z_sym, idx, self.eb_tables)

    def _eb_decode(self, strings: Sequence[bytes],
                   shape: Tuple[int, int]) -> np.ndarray:
        from .codec import _decode_planes

        C = self.eb_tables.cdf_length.shape[0]
        idx = np.ascontiguousarray(np.broadcast_to(
            np.arange(C, dtype=np.int32), (len(strings), *shape, C)))
        return _decode_planes(strings, idx, self.eb_tables)

    # -- pipelined serving ---------------------------------------------------

    # Default hooks: eager, no overlap. CheckerboardCodec (and HyresCodec,
    # by composition) split compress and decompress for real: every device
    # op of request i is queued before request i+1's, and i's pull and host
    # framing run while i+1's work executes.
    def _compress_dispatch(self, x):
        with span("compress.dispatch"):
            return ("eager", self.compress(x))

    def _compress_finish(self, state) -> Dict:
        with span("compress.finish"):
            return state[1]

    def _dec_dispatch_from_comp(self, comp: Dict):
        """-> (x_hat, decoded symbols, start time, event after the decode's
        device work or None), without waiting for the decode."""
        start = time.perf_counter()
        with span("decompress.dispatch"):
            d = self.decompress(comp["strings"], comp["shape"], comp.get("size"))
        return d["x_hat"], d["symbols"], start, None

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
            (x_hat, symbols, start, done), comp = item
            with span("decompress.wait"):
                wait_event(done)
            dec_time = time.perf_counter() - start
            outs.append({
                "x_hat": x_hat,
                "symbols": symbols,
                "compressed": comp,
                "strings": comp["strings"],
                "shape": comp["shape"],
                "time": {"compression": comp["time"], "decompression": dec_time,
                         "total": comp["time"] + dec_time},
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
        """One timed roundtrip (reference ``checkerboard.py:242-259``)."""
        comp = self.compress(x)
        dec = self.decompress(comp["strings"], comp["shape"], comp.get("size"))
        return {
            "x_hat": dec["x_hat"],
            "symbols": dec["symbols"],
            "strings": comp["strings"],
            "shape": comp["shape"],
            "time": {"compression": comp["time"], "decompression": dec["time"],
                     "total": comp["time"] + dec["time"]},
        }
