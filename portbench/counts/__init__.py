"""The work a cell's calls do, counted on the reference and from shapes, so
that every later change to the program is measured against the same work.

``flops``: the floating-point operations of the reference's compress,
decompress and training step at the cell's shapes, counted by
``torch.utils.flop_counter.FlopCounterMode`` on meta tensors (the
convolutions, transposed convolutions and matrix products; elementwise
work is not counted). ``coder_bytes``: the least bytes the rANS coder must
move for a request: every symbol (2 bytes) and every Gaussian plane's
scale index (1 byte) read once by the encoder and written once by the
decoder, the coded stream (the payload's bytes) written once and read
once, and the CDF tables read once.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import jpeg as J

SCALES = (0.11, 256.0, 64)  # the Gaussian conditional's scale table: min, max, levels
TAIL_MASS = 1e-9
SYMBOL_BYTES, INDEX_BYTES, CDF_BYTES = 2, 1, 4


def _meta(W: dict, grad: bool = False) -> dict:
    return {k: torch.empty(v.shape, device="meta", requires_grad=grad) for k, v in W.items()}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def serve_flops(cfg: dict, refmod, W: dict, h: int, w: int) -> dict:
    ref = refmod.Reference(cfg, _meta(W))
    x = torch.empty((1, h, w, 3), device="meta")
    box = {}

    def enc():
        box["e"] = ref.encode(x)

    fc = _counted(enc)
    e = box["e"]
    jpeg = (e["coefs"], J.qtables(int(cfg["jpeg_quality"]))) if "coefs" in e else None
    fd = _counted(lambda: ref.decode(e["symbols"], h, w, jpeg))
    return {"compress": fc, "decompress": fd, "roundtrip": fc + fd}


def train_flops(cfg: dict, refmod, W: dict, tr: dict, noise_shapes: dict) -> int:
    """One RD step: the loss's forward and its backward."""
    ref = refmod.Reference(cfg, _meta(W))
    Wm = _meta(W, grad=True)
    b, s = int(tr["batch"]), int(tr["crop"])
    x = torch.empty((b, s, s, 3), device="meta")
    noise = {k: torch.empty(v, device="meta") for k, v in noise_shapes.items()}
    return _counted(lambda: ref.loss(Wm, x, noise, float(tr["lambda"])).backward())


def gaussian_table_entries() -> int:
    """CDF entries of the scale table: per scale s, 2 ceil(s m) + 1 symbols
    (m the normal's quantile at TAIL_MASS / 2) plus the escape and the end."""
    lo, hi, n = SCALES
    m = -float(torch.special.ndtri(torch.tensor(TAIL_MASS / 2, dtype=torch.float64)))
    scales = [math.exp(math.log(lo) + i * (math.log(hi) - math.log(lo)) / (n - 1)) for i in range(n)]
    return sum(2 * math.ceil(s * m) + 1 + 2 for s in scales)


def prior_table_entries(W: dict) -> int:
    """CDF entries of the factorized prior: per channel its integer support
    between the quantiles around the median, plus the escape and the end."""
    q = W["entropy_bottleneck.quantiles"].detach().double().cpu()
    med = q[:, 0, 1]
    lo = torch.clamp(torch.ceil(med - q[:, 0, 0]), min=0)
    hi = torch.clamp(torch.ceil(q[:, 0, 2] - med), min=0)
    return int((lo + hi + 1 + 2).sum())


def _nbytes(strings) -> int:
    if isinstance(strings, (bytes, bytearray)):
        return len(strings)
    return sum(_nbytes(s) for s in strings)


def coder_bytes(W, payloads) -> dict:
    """Per request of the profiled slice: the least bytes of its encode
    (K3) and of its decode (K4 and K5)."""
    tables = CDF_BYTES * (gaussian_table_entries() + prior_table_entries(W))
    enc, dec = [], []
    for p in payloads:
        syms = p["symbols"]
        n_z, n_y = int(syms[0].numel()), sum(int(s.numel()) for s in syms[1:])
        stream = _nbytes(p["strings"])
        moved = SYMBOL_BYTES * (n_z + n_y) + INDEX_BYTES * n_y + stream + tables
        enc.append(moved)
        dec.append(moved)
    return {"encode": enc, "decode": dec}
