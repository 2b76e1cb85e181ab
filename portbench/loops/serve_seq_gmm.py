"""``serve_seq`` for a codec whose y planes code under a Gaussian mixture:
the same closed loop, window and profiled slice, with what the mixture
coder adds.

``work`` adds the mixture coding's least bytes (``counts/gmm.py``) and the
program's ``GMM_STATS`` counted over the profiled slice. ``check`` adds ``gmm_rate_gap``: the worst
checked request's |y payload bytes - ideal bytes| / ideal bytes, the ideal
being the code length of its decoded y symbols under the reference's
float64 mixture. Decoding stays exact whatever rows both sides build, so
rows built from one component, or built loosely, show only here.
"""

from __future__ import annotations

from pathlib import Path

import torch

from hyres_tpu_torch.models.codec import gmm_stats, reset_gmm_stats
from portbench.counts import _nbytes
from portbench.counts.gmm import gmm_bytes
from portbench.lib import spec
from portbench.reference import common as C

_BASE = spec.load_module(Path(__file__).with_name("serve_seq.py"))


class Loop(_BASE.Loop):
    def slice(self):
        reset_gmm_stats()
        super().slice()

    def work(self, rec):
        super().work(rec)
        c = self.ctx
        rec["gmm_bytes"] = gmm_bytes(c.W, self.payloads, int(c.cell.config["mixtures"]))
        rec["gmm_stats"] = gmm_stats()

    def check(self):
        checks, failed = super().check()
        if "gmm_rate_gap" in self.ctx.cell.limits:
            checks["gmm_rate_gap"]["value"] = self.rate_gap()
        return checks, failed

    def rate_gap(self) -> float:
        c = self.ctx
        ref = c.refmod.Reference(c.cell.config, c.W)
        worst = 0.0 if self.kept else float("inf")
        with C.float32_numerics():
            for k in self.kept:
                syms = [torch.as_tensor(s).to(c.device) for s in k.decoded]
                ideal = ref.ideal_bits(syms) / 8.0
                worst = max(worst, abs(_nbytes(k.payload["strings"][0]) - ideal) / ideal)
        return worst
