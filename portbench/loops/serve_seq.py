"""One client in a closed loop: a request's compress, then the decompress
of its payload, back to back, each timed around the public call.

Traffic keys: ``photo``, ``shapes``, ``grid`` (the requests,
``lib/traffic.py``), ``warmup_roundtrips``, ``sample_every`` (one request
in this many is checked) and ``trace_requests`` (roundtrips in the
profiled slice).
"""

from __future__ import annotations

import time

from portbench.lib import traffic as T
from portbench.lib.serving import ServingLoop, roundtrip, traced_roundtrip


class Loop(ServingLoop):
    def _roundtrip(self, req):
        c = self.ctx
        return roundtrip(self.codec, c.cfgmod.decompress, c.photos.window(req), c.spans)

    def warm(self):
        # one roundtrip of each shape, then the traffic's number in order
        for s in T.shapes(self.reqs):
            self._roundtrip(next(r for r in self.order if r[:2] == s))
        for k in range(int(self.tr["warmup_roundtrips"])):
            self._roundtrip(self.order[k % len(self.order)])

    def window(self, seconds: float) -> dict:
        walls_c, walls_d, shapes = [], [], []
        i = 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            req = self.order[i % len(self.order)]
            comp, (x_hat, syms), tc, td = self._roundtrip(req)
            walls_c.append(tc)
            walls_d.append(td)
            shapes.append(req[:2])
            self.keep(i, req, comp, syms, x_hat)
            i += 1
        return {"window_s": time.perf_counter() - t_start, "images": i, "shapes": shapes,
                "calls": {"compress": walls_c, "decompress": walls_d}}

    def slice(self):
        c = self.ctx
        for k in range(int(self.tr["trace_requests"])):
            req = self.order[k % len(self.order)]
            self.payloads.append(traced_roundtrip(self.codec, c.cfgmod.decompress,
                                                  c.photos.window(req), c.spans))

    def work(self, rec):
        super().work(rec)
        f = self.flops()
        rec["call_flops"] = {call: [f[s][call] for s in rec["shapes"]]
                             for call in ("compress", "decompress")}
