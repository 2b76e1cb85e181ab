"""The ``tcm.serve-seq`` cell's files on the CPU: the configuration builds
the program's model with the parameters the reference reads, the
reference imports nothing of the program, the attention counts of
``counts/window_attn.py`` match a hand count, the roofline reader reads
only when the profiled slice's K7 launches match the reference's attention
calls, the program's fixed structure is the configuration's,
and the cell runs at the small size of ``conftest.small_cell`` with the
program agreeing with the reference."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.counts import window_attn as WA
from portbench.lib import harness, spec
from portbench.tests.conftest import SMALL_SEED, small_cell
from portbench.tests.test_portbench_imports import top_level_imports

CELL = "tcm.serve-seq"
NAME = "tcm-n128-m320"


def _cfg(**kw):
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{NAME}.json").read_text())
    return {**cfg, "name": NAME, **kw}


def test_the_configuration_builds_what_the_reference_reads():
    cfg = _cfg()
    model = spec.config_module(cfg)._model(cfg)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    assert sum(v.numel() for v in model.state_dict().values()) > 70e6
    assert shapes["g_a.ConvTransBlock_0.Block_0.WindowAttention_0.relative_position_params"] == \
        (16, 15, 15)
    assert shapes["h_a.ConvTransBlock_1.Block_0.WindowAttention_0.relative_position_params"] == \
        (4, 7, 7)
    read = set()

    class Seen(dict):
        def __getitem__(self, k):
            read.add(k)
            return super().__getitem__(k)

        def get(self, k, default=None):
            return self[k] if k in self else default

    W = Seen({k: torch.empty(s, device="meta") for k, s in shapes.items()})
    ref = spec.reference_module(cfg).Reference(cfg, W)
    with torch.no_grad():
        e = ref.encode(torch.empty((1, 128, 128, 3), device="meta"))
        ref.decode(e["symbols"], 128, 128)
    # every parameter but the prior's density (the coder's tables) is read
    assert set(shapes) - read == {k for k in shapes if k.startswith("entropy_bottleneck.")
                                  and not k.endswith("quantiles")}


def test_the_reference_imports_nothing_of_the_program():
    path = spec.BENCH_DIR / "reference" / f"{NAME}.py"
    assert "hyres_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & {"jax", "flax", "hyres_tpu"}


def _blocks(h=128, w=128):
    cfg = _cfg()
    model = spec.config_module(cfg)._model(cfg)
    return WA.blocks(cfg, spec.reference_module(cfg), model.state_dict(), h, w)


def test_attention_counts_by_hand():
    """At 128x128 (N=128): g_a's stages at 64x64, 32x32 and 16x16 tokens, h_a
    and each h_s at 4x4, SWAtten's 20 at 8x8 (y), g_s mirrored."""
    b = _blocks()
    ga = [(4096, 128, 8, 8), (1024, 128, 16, 8), (256, 128, 32, 8)]
    hyper = [(16, 128, 32, 4)]
    sw = [(64, 128, 16, 8)]
    two = lambda blks: [t + (s,) for t in blks for s in (False, True)]  # noqa: E731
    assert b["compress"] == two(ga) + two(hyper) + two(hyper) * 2 + two(sw) * 10
    assert b["decompress"] == two(hyper) * 2 + two(sw) * 10 + two(ga[::-1])
    assert (len(b["compress"]), len(b["decompress"])) == (32, 30)
    peak = harness.PEAK
    tokens, C, d, p = 4096, 128, 8, 8
    nbytes = 4 * (3 * tokens * C + tokens * C + (C // d) * p ** 4)
    flops = 2 * 2 * tokens * p * p * C
    assert WA.least_seconds((tokens, C, d, p, False), peak) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))


def _run(k7_seconds):
    kernel = "void (anonymous namespace)::window_attn_kernel<8, 8>(float const*, float const*)"
    span = {"wall": 1.0, "busy": 1.0, "kernels": {kernel: k7_seconds, "encode_kernel": 1.0}}
    return {"shapes": [(128, 128)] * 3, "peak": harness.PEAK,
            "trace": {"spans": {"compress": [span, span], "decompress": [span, span]}}}


def test_the_roofline_reads_only_when_the_launches_match(monkeypatch):
    cfg = _cfg()
    model = spec.config_module(cfg)._model(cfg)
    monkeypatch.setattr(WA, "_BOUND", {})
    assert WA.roofline(_run(1e-3), "compress") is None  # nothing bound
    WA.bind(cfg, spec.reference_module(cfg), model.state_dict())
    b = _blocks()
    least = 2 * sum(WA.least_seconds(x, harness.PEAK) for x in b["compress"])
    monkeypatch.setattr(WA, "slice_launches", lambda: 2 * 32 + 2 * 30)
    got = WA.roofline(_run(1e-3), "compress")
    assert got == pytest.approx(100 * least / 2e-3)
    assert spec.metric_module("window_attn_roofline.decompress").read(_run(1e-3)) > 0
    monkeypatch.setattr(WA, "slice_launches", lambda: 2 * 32 + 2 * 30 - 1)
    assert WA.roofline(_run(1e-3), "compress") is None
    monkeypatch.setattr(WA, "slice_launches", lambda: 2 * 32 + 2 * 30)
    assert WA.roofline({**_run(0.0)}, "compress") is None  # no K7 time in the spans


def test_the_slice_launches_are_those_since_the_last_mark(monkeypatch):
    """The configuration's decompress marks the program's K7 launches; the
    slice's are the launches after the last mark, and none without a mark
    or without the program's counter."""
    from hyres_tpu_torch.kernels import window_attn as k7

    monkeypatch.setattr(WA, "_BOUND", {})
    monkeypatch.setitem(k7.WINDOW_ATTN_STATS, "launches", 100)
    assert WA.slice_launches() is None
    WA.mark()
    monkeypatch.setitem(k7.WINDOW_ATTN_STATS, "launches", 162)
    assert WA.slice_launches() == 62
    WA.mark()
    assert WA.slice_launches() == 0
    monkeypatch.setattr(WA, "program_launches", lambda: None)
    assert WA.slice_launches() is None


@pytest.mark.parametrize("key,const", [("head_dims", "HEAD_DIMS"), ("slices", "SLICES"),
                                       ("max_support", "MAX_SUPPORT"),
                                       ("hyper_window", "HYPER_WINDOW"),
                                       ("hyper_head_dim", "HYPER_HEAD_DIM"),
                                       ("swatten_head_dim", "SWATTEN_HEAD_DIM")])
def test_the_program_fixes_the_configuration_s_structure(key, const):
    """What the program fixes, and the reference reads from the
    configuration, are the same numbers."""
    from hyres_tpu_torch.models import tcm

    want = _cfg()[key]
    got = getattr(tcm, const)
    assert (list(got) if isinstance(want, list) else got) == want


def test_the_cell_runs_and_the_program_agrees_with_the_reference():
    """The whole cell at 64x64 requests (padded to 128x128) on the CPU,
    traced: correct, and no roofline without the kernel's launches."""
    r = harness.run(small_cell(CELL), SMALL_SEED, 1.0, True, device_name="cpu",
                    log=lambda m: None)
    assert r["correct"], r["checks"]
    assert "window_attn_roofline.compress" not in r["metrics"]
