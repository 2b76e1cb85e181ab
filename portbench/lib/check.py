"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference (``reference/<config>.py``) after the
window, with the program's state freed.

Serving, over the requests the window kept (one in ``sample_every``, at a
phase drawn from the seed):

- ``decoded_vs_coded``: symbols the decompress decoded that differ from
  those the compress coded, summed (the coder is exact: limit 0);
- ``symbol_mismatch_share``: the worst request's share of coded symbols
  that differ from the reference's encode of the same window;
- ``jpeg_coef_mismatch_share`` (a JPEG base layer): the worst request's
  share of JPEG coefficients, read back from its JFIF bytes by the
  reference's own Huffman decoder, that differ from the reference's
  encode (1 for a header that is not the quality's baseline 4:2:0 frame);
- ``recon_rmse``: the worst request's RMS gap between the program's
  reconstruction and the reference's decode of the same payload (the
  served symbols, and the coefficients parsed from the JFIF bytes).

Training, over the first ``checked_steps`` steps of the run's own step
object, the reference following the same batches and noise from the same
starting weights:

- ``loss_gap``: |loss - reference| / |reference| of the first step (the
  JPEG rate in both counts the scan's Huffman bits padded to a byte plus
  the headers, without stuffed zero bytes, as HyRES's objective does);
- ``grad_gap``: the worst leaf's gap of the first step's gradient norms
  (as the optimizers got it, after the clip), over the larger of the
  reference leaf's norm and the median leaf's;
- ``grad_gap_median``: the median leaf's gap of the same;
- ``delta_gap``: the median leaf's gap of the norms of its change over the
  checked steps, over the larger of the reference leaf's and the median.

The later steps' losses and the worst leaf's change are reported beside
them and not compared: Adam's first steps move an element by the learning
rate whatever its gradient's size, so an element whose gradient is
round-off on one side (a unit at the edge of its ReLU) moves a full step
on one side and not on the other, in sound runs too. The reference's
training steps run cuDNN as the recipe does, with autotuned float32
algorithms and TF32 off. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out (they move by round-off alone).
"""

from __future__ import annotations

import statistics

import torch

from ..reference import common as C
from ..reference import jpeg as J

MOVED = 1e-3  # a leaf counts when its reference gradient is >= this x the median


def _entry(value, limit):
    return {"value": float(value), "limit": float(limit)}


def _jpeg_from_payload(buf: bytes, quality: int, device):
    """(coefficients, quant tables) of a JFIF buffer, or None where it is
    not the quality's baseline 4:2:0 frame."""
    p = J.parse_jfif(buf)
    qy, qc = J.qtables(quality)
    if (p["sampling"] != [(2, 2), (1, 1), (1, 1)]
            or not all((a == b).all() for a, b in zip(p["qt"], (qy, qc, qc)))):
        return None
    return [torch.from_numpy(c)[None].to(device) for c in p["coefs"]], (qy, qc)


def serve_numbers(ref, cfg: dict, x, coded, decoded, x_hat, jpeg_in, device) -> dict:
    """The numbers of one request (see the module's docstring). ``jpeg_in``:
    the request's JFIF bytes, or (coefficients, quant tables) where a
    control stands in the program's place, or None without a base layer."""
    coded = [torch.as_tensor(s).to(device) for s in coded]
    decoded = [torch.as_tensor(s).to(device) for s in decoded]
    with torch.no_grad():
        jpeg, bad_frame = None, False
        if "jpeg_quality" in cfg:
            q = int(cfg["jpeg_quality"])
            jpeg = jpeg_in
            if isinstance(jpeg_in, (bytes, bytearray)):
                try:
                    jpeg = _jpeg_from_payload(jpeg_in, q, device)
                except (ValueError, IndexError, KeyError):
                    jpeg = None
            bad_frame = jpeg is None
        # the residual codec is judged on the base layer the judged side sent
        e = ref.encode(x, jpeg)
        out = {"decoded_vs_coded": sum(int((a != b).sum()) if a.shape == b.shape else a.numel()
                                       for a, b in zip(coded, decoded))}
        n = sum(s.numel() for s in e["symbols"])
        out["symbol_mismatch_share"] = sum(C.mismatch_share(a, b) * a.numel()
                                           for a, b in zip(e["symbols"], coded)) / n
        if "coefs" in e:
            if bad_frame:
                out["jpeg_coef_mismatch_share"] = 1.0
                jpeg = (e["coefs"], J.qtables(q))
            else:
                nc = sum(c.numel() for c in e["coefs"])
                out["jpeg_coef_mismatch_share"] = sum(
                    C.mismatch_share(a, b) * a.numel() for a, b in zip(e["coefs"], jpeg[0])) / nc
        out["recon_rmse"] = C.rmse(ref.decode(decoded, x.shape[1], x.shape[2], jpeg), x_hat)
    return out


def serve(cell, refmod, W, kept, photos, device):
    """-> (checks, requests whose decoded symbols differ from the coded)."""
    ref = refmod.Reference(cell.config, W)
    worst: dict = {}
    failed = 0
    with C.float32_numerics():
        for k in kept:
            buf = k.payload["jpeg_buffers"][0] if "jpeg_buffers" in k.payload else None
            nums = serve_numbers(ref, cell.config, photos.window(k.req), k.coded, k.decoded,
                                 k.x_hat, buf, device)
            failed += nums["decoded_vs_coded"] > 0
            for name, v in nums.items():
                worst[name] = (v + worst.get(name, 0) if name == "decoded_vs_coded"
                               else max(v, worst.get(name, 0.0)))
    checks = {"requests_unchecked": _entry(0 if kept else 1, 0)}
    for name, limit in cell.limits.items():
        checks[name] = _entry(worst.get(name, float("inf")), limit)
    return checks, failed


def train_numbers(ref, cfg, W, tr, checked, name_of, device) -> dict:
    """The numbers of the checked steps (see the module's docstring)."""
    Wt = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
    lmbda = float(tr["lambda"])
    with C.float32_numerics(autotuned=True):  # the recipe's cuDNN policy, TF32 off
        out = C.train_steps(Wt, lambda w, x, noise: ref.loss(w, x, noise, lmbda),
                            [b[0] for b in checked["batches"]],
                            [b[1] for b in checked["batches"]],
                            {"lr": tr["lr"], "aux_lr": tr["aux_lr"], "clip": tr["clip"]})
    loss_p = [float(v) for v in checked["loss"]]
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(loss_p, out["loss"])]
    g_ref = out["grad1"]
    med_g = statistics.median(g_ref.values())
    counted = [n for n in checked["grad1"] if g_ref[name_of(n)] >= MOVED * med_g]
    g_gaps, d_ref, d_prog = {}, {}, {}
    for n in counted:
        r = g_ref[name_of(n)]
        p = float(torch.linalg.vector_norm(checked["grad1"][n].double()))
        g_gaps[n] = abs(p - r) / max(r, med_g)
        d_ref[n] = float(torch.linalg.vector_norm((Wt[name_of(n)].detach() - W[name_of(n)]).double()))
        d_prog[n] = float(torch.linalg.vector_norm(
            (checked["after"][n] - checked["before"][n]).double()))
    med_d = statistics.median(d_ref.values())
    d_gaps = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med_d) for n in counted}
    worst_g, worst_d = max(g_gaps, key=g_gaps.get), max(d_gaps, key=d_gaps.get)
    return {"loss_gap": loss_gaps[0], "grad_gap": g_gaps[worst_g],
            "grad_gap_median": statistics.median(g_gaps.values()),
            "delta_gap": statistics.median(d_gaps.values()),
            "loss_gaps": loss_gaps, "grad_gap_leaf": worst_g,
            "delta_gap_worst": d_gaps[worst_d], "delta_gap_leaf": worst_d,
            "leaves_left_out": sorted(set(checked["grad1"]) - set(counted))}


def train(cell, refmod, W, checked, cfgmod, device):
    ref = refmod.Reference(cell.config, W)
    nums = train_numbers(ref, cell.config, W, cell.traffic, checked, cfgmod.reference_name, device)
    return {name: _entry(nums[name], limit) for name, limit in cell.limits.items()}
