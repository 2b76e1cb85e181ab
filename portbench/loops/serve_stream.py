"""A batch job: ``inference_stream(xs, depth)`` over lists of ``list_len``
requests, back to back; the rate counts the roundtrips that the window's
lists completed.

Traffic keys: ``photo``, ``shapes``, ``grid`` (the requests,
``lib/traffic.py``), ``list_len``, ``depth``, ``warmup_lists`` and
``sample_every`` (one request in this many is checked; a value prime to
``list_len`` moves the checked slot from list to list).
"""

from __future__ import annotations

import time

from portbench.lib.serving import ServingLoop


class Loop(ServingLoop):
    def _list(self, first: int):
        n = int(self.tr["list_len"])
        return [self.order[(first + j) % len(self.order)] for j in range(n)]

    def _stream(self, reqs):
        c = self.ctx
        with c.spans("stream"):
            return self.codec.inference_stream([c.photos.window(r) for r in reqs],
                                               int(self.tr["depth"]))

    def warm(self):
        for k in range(int(self.tr["warmup_lists"])):
            self._stream(self._list(k * int(self.tr["list_len"])))

    def window(self, seconds: float) -> dict:
        shapes = []
        i = 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            reqs = self._list(i)
            for j, o in enumerate(self._stream(reqs)):
                self.keep(i + j, reqs[j], o["compressed"], o["symbols"], o["x_hat"])
            shapes += [r[:2] for r in reqs]
            i += len(reqs)
        return {"window_s": time.perf_counter() - t_start, "images": i, "shapes": shapes,
                "calls": {}}

    def slice(self):
        self._stream(self._list(0))

    def work(self, rec):
        super().work(rec)
        f = self.flops()
        rec["window_flops"] = sum(f[s]["roundtrip"] for s in rec["shapes"])
