"""The FLOP and byte counts, and the per-layer readers, on hand-made
inputs."""

from __future__ import annotations

import math
import statistics

import pytest
import torch

from portbench import counts
from portbench.lib import readers, spec
from portbench.reference import jpeg as J
from portbench.reference import nets as R

PEAK = {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def test_a_convolution_counts_two_flops_a_multiply_add():
    W = {"c.weight": torch.empty(8, 4, 3, 3, device="meta"),
         "c.bias": torch.empty(8, device="meta")}
    x = torch.empty(1, 4, 16, 16, device="meta")
    n = counts._counted(lambda: R.conv(W, "c", x))
    assert n == 2 * 8 * 16 * 16 * 4 * 3 * 3


def test_the_jpeg_transform_counts_its_matrix_products():
    x = torch.empty(1, 16, 16, 3, device="meta")
    # per 8x8 block two 8x8 products (D X, then (D X) D^T): 2 * 2 * 8^3 flops;
    # a 16x16 image has 4 luma and 1 + 1 chroma blocks
    assert counts._counted(lambda: J.encode(x, 1)) == 6 * 2 * 2 * 8 ** 3


def test_serving_flops_of_the_hyres_reference_scale_with_the_area():
    cfg = spec.resolve(spec.load_benchmark(), "hyres.serve-seq").config
    refmod = spec.reference_module(cfg)
    W = spec.config_module(cfg).reference_weights(cfg, spec.ROOT, "cpu", refmod)
    small = counts.serve_flops(cfg, refmod, W, 128, 128)
    big = counts.serve_flops(cfg, refmod, W, 256, 256)
    assert big["compress"] == pytest.approx(4 * small["compress"], rel=1e-9)
    assert small["roundtrip"] == small["compress"] + small["decompress"]


def test_gaussian_table_entries_by_hand():
    m = -statistics.NormalDist().inv_cdf(0.5e-9)
    lo, hi, n = counts.SCALES
    s = [math.exp(math.log(lo) + i * (math.log(hi) - math.log(lo)) / (n - 1)) for i in range(n)]
    assert counts.gaussian_table_entries() == sum(2 * math.ceil(v * m) + 3 for v in s)


def test_coder_bytes_by_hand():
    W = {"entropy_bottleneck.quantiles": torch.tensor([[[-2.5, 0.25, 3.0]]])}
    assert counts.prior_table_entries(W) == (3 + 3 + 1 + 2)
    p = {"symbols": [torch.zeros(1, 2, 2, 4), torch.zeros(1, 8, 4, 6), torch.zeros(1, 8, 4, 6)],
         "strings": [[[b"abc"], [b"de"]], [b"f"]]}
    got = counts.coder_bytes(W, [p])
    tables = 4 * (counts.gaussian_table_entries() + 9)
    want = 2 * (16 + 2 * 192) + 1 * (2 * 192) + 6 + tables
    assert got == {"encode": [want], "decode": [want]}


def test_readers_on_a_hand_made_run():
    run = {"calls": {"compress": [0.02, 0.03], "decompress": [0.05, 0.05]},
           "window_s": 2.0, "images": 10, "steps": 5, "peak": PEAK,
           "call_flops": {"compress": [67e10, 67e10], "decompress": [67e10, 67e10]},
           "window_flops": 10 * 134e10,
           "trace": {"spans": {"compress": [{"wall": 0.02, "busy": 0.005,
                                             "kernels": {"void encode_kernel(EncArgs)": 0.001}},
                                            {"wall": 0.02, "busy": 0.015, "kernels": {}}]}},
           "coder_bytes": {"encode": [3.35e6, 3.35e6]}}
    assert readers.idle_share(run, "compress") == pytest.approx(50.0)
    assert readers.idle_share(run, "decompress") is None
    assert readers.mfu_calls(run, "compress") == pytest.approx(100 * 2 * 0.01 / 0.05)
    assert readers.mfu_window(run) == pytest.approx(100 * 10 * 0.02 / 2)
    assert readers.mfu_window({**run, "window_flops": None}) is None
    # 6.7 MB at 3.35 TB/s is 2 us, in 1 ms of kernel time
    assert readers.roofline(run, "compress", r"\bencode_kernel\b", "encode") == pytest.approx(0.2)
    assert readers.roofline(run, "compress", "decode_warp_kernel", "encode") is None
    for name in ("mfu.compress", "idle_share.compress", "rans_encode_roofline"):
        assert spec.metric_module(name).read(run) is not None
    assert spec.metric_module("idle_share.train").read(run) is None


class _Ev:
    def __init__(self, name, start, end, kind, annotation=False):
        from types import SimpleNamespace

        self.name, self.is_user_annotation = name, annotation
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = SimpleNamespace(name=kind)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_read_profile_on_a_hand_made_trace():
    from portbench.lib.trace import read_profile

    prof = _Prof([
        _Ev("pb.compress", 0, 1000, "CPU"), _Ev("pb.compress.dispatch", 0, 600, "CPU"),
        _Ev("pb.decompress", 1000, 2000, "CPU"),
        _Ev("void encode_kernel(EncArgs)", 100, 300, "CUDA"),
        _Ev("conv", 200, 500, "CUDA"), _Ev("conv", 1200, 1700, "CUDA"),
        _Ev("Optimizer.step#Adam.step", 0, 2000, "CUDA", annotation=True),
        _Ev("pb.compress", 0, 1000, "CUDA")])
    t = read_profile(prof, 0.0025)
    c, d = t["spans"]["compress"][0], t["spans"]["decompress"][0]
    assert c["wall"] == pytest.approx(1e-3) and c["busy"] == pytest.approx(4e-4)
    assert c["kernels"] == {"void encode_kernel(EncArgs)": pytest.approx(2e-4),
                            "conv": pytest.approx(3e-4)}
    assert d["busy"] == pytest.approx(5e-4)
    assert t["busy_s"] == pytest.approx(9e-4) and t["window_s"] == 0.0025
    assert dict(t["device_ops"]) == {"conv": pytest.approx(8e-4),
                                     "void encode_kernel(EncArgs)": pytest.approx(2e-4)}
    # idle: 0-100 and 500-600 in the dispatch, 600-1000 in compress, 1000-1200
    # and 1700-2000 in decompress
    assert dict(t["idle_gaps"]) == {"compress.dispatch": pytest.approx(2e-4),
                                    "compress": pytest.approx(4e-4),
                                    "decompress": pytest.approx(5e-4)}
