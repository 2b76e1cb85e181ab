"""The CUDA graphs of the compress's dispatch half (``models/graphs.py``),
on the CPU.

A CPU tensor never captures: on the CPU and under the host coder every
compress runs op by op. The graph's key separates batch, shape, dtype and
pull plan; ``reset_wire_stats`` clears the graph counters. The engine
itself runs here on an emulated graph: ``_capture`` is replaced by one
that replays by running the captured function again and copying its
outputs over the captured ones in place, as a replay overwrites the
graph's memory. Under it every family's compresses (eager, capturing,
replaying), streams at depths 2 and 3, a miss's re-pull while a later
request's replay has run, and the host-coder fallback give the bytes and
symbols of the same calls run op by op. The card's own graphs are held in
``tests/test_torch_cuda.py``.
"""

import collections
from pathlib import Path

import numpy as np
import pytest
import torch

from hyres_tpu_torch.kernels import rans as krans
from hyres_tpu_torch.models import (Cheng2020Codec, Cheng2020withCheckerboard, ElicCodec,
                                    LightWeightELIC)
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.models import graphs
from hyres_tpu_torch.models.hyres import HyresCodec
from hyres_tpu_torch.nn import init_parameters
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
FAMILIES = ["hyres", "elic", "cheng2020", "cheng2020-attn-gmm3"]


def _codec(family: str, coder: str = "device"):
    if family == "hyres":
        return HyresCodec.from_artifact(ARTIFACT, device="cpu", coder=coder)
    gmm = family == "cheng2020-attn-gmm3"
    if family == "elic":
        model, cls = LightWeightELIC(16, 24, (4, 4, 8, 8)), ElicCodec
    else:
        model = Cheng2020withCheckerboard(16, attention=gmm, mixtures=3 if gmm else 1)
        cls = Cheng2020Codec
    codec = cls(init_parameters(model, torch.Generator().manual_seed(0)).eval(),
                coder=coder, device="cpu")
    codec.update(force=True)
    return codec


def _requests(n: int):
    """n distinct 64x64 windows of the photo, of one shape."""
    img = load_image(IMAGE)
    return [torch.from_numpy(np.array(img[:, 64 * k:64 * k + 64, 96:160])) for k in range(n)]


def _same(a: dict, b: dict) -> None:
    assert a["strings"] == b["strings"]
    assert a.get("jpeg_buffers") == b.get("jpeg_buffers")
    assert len(a["symbols"]) == len(b["symbols"])
    for s, t in zip(a["symbols"], b["symbols"]):
        assert torch.equal(torch.as_tensor(s), torch.as_tensor(t))


@pytest.fixture
def emulated(monkeypatch):
    """Graphs engage on the CPU; a replay runs the captured function again,
    uncounted, and copies its outputs over the captured ones; the pull
    copies its blob, as the card's copy into a host buffer does."""

    def capture(fn, device):
        out = fn()

        def replay():
            snap = graphs._snapshot()
            new = fn()
            graphs._restore(snap)
            out.arena.copy_(new.arena)
            out.blob.copy_(new.blob)
        return replay, out

    monkeypatch.setattr(graphs, "engaged", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(tcodec, "pull_dispatch", lambda blob: (blob.clone(), None))


@pytest.mark.parametrize("coder", ["device", "host"])
def test_cpu_and_host_coder_never_capture(coder):
    codec = _codec("hyres", coder)
    (x,) = _requests(1)
    tcodec.reset_wire_stats()
    outs = [codec.compress(x) for _ in range(3)]
    w = tcodec.WIRE_STATS
    assert w["graph_captures"] == w["graph_replays"] == 0
    assert w["eager_dispatches"] == (3 if coder == "device" else 0)
    assert codec._dispatch_graphs() is None
    for out in outs[1:]:
        _same(out, outs[0])


SPEC = tcodec.Speculative(((32, 4096, 0), (128, 8192, 0)), None, None, None, 0)


@pytest.mark.parametrize("other", [
    (torch.zeros(2, 64, 64, 3), SPEC),                       # batch
    (torch.zeros(1, 64, 128, 3), SPEC),                      # shape
    (torch.zeros(1, 64, 64, 3, dtype=torch.float64), SPEC),  # dtype
    (torch.zeros(1, 64, 64, 3), SPEC._replace(plans=((32, 8192, 0), (128, 8192, 0)))),
    (torch.zeros(1, 64, 64, 3), SPEC._replace(plans=((32, 4096, 256), (128, 8192, 0)))),
    (torch.zeros(1, 64, 64, 3), SPEC._replace(cols=(0, 1, 8), colmask=0x103)),
    (torch.zeros(1, 64, 64, 3), SPEC._replace(coef_cap=4096)),
    (torch.zeros(1, 64, 64, 3), None),                       # the shape alone
], ids=["batch", "shape", "dtype", "stream", "escapes", "columns", "coef_cap", "no_plan"])
def test_graph_key_separates_batch_shape_dtype_and_plan(other):
    key = graphs.graph_key(torch.zeros(1, 64, 64, 3), SPEC)
    assert key == graphs.graph_key(torch.ones(1, 64, 64, 3), SPEC)
    assert key != graphs.graph_key(*other)
    assert hash(key) == hash(graphs.graph_key(torch.ones(1, 64, 64, 3), SPEC))


def test_reset_wire_stats_clears_graph_counters():
    for k in ("graph_captures", "graph_replays", "eager_dispatches"):
        tcodec.WIRE_STATS[k] = 7
    tcodec.reset_wire_stats()
    assert all(tcodec.WIRE_STATS[k] == 0
               for k in ("graph_captures", "graph_replays", "eager_dispatches"))


def test_outputs_leave_in_one_buffer_of_their_own():
    """Mixed dtypes in nested lists, tuples and dicts come back equal, each
    aligned to its element size, from one copy of the packed buffer."""
    g = torch.Generator().manual_seed(0)
    tree = (torch.randint(-9, 9, (1, 3, 5), dtype=torch.int16, generator=g),
            [(torch.randint(0, 255, (1, 7), dtype=torch.uint8, generator=g),
              (torch.randint(-9, 9, (1, 3), dtype=torch.int32, generator=g),
               torch.randint(-9, 9, (1, 3, 2), dtype=torch.int16, generator=g)))],
            None,
            [{"states": torch.randint(0, 9, (1, 32), dtype=torch.int32, generator=g),
              "n_esc": torch.zeros(1, dtype=torch.int32),
              "stream": torch.randint(-9, 9, (1, 11), dtype=torch.int16, generator=g)}])
    leaves = []
    flat = graphs._flatten(tree, leaves)
    arena, layout = graphs._pack(leaves)
    assert arena.dtype == torch.uint8 and arena.numel() == sum(n for _, n, _, _ in layout)
    assert all(o % torch.empty(0, dtype=dt).element_size() == 0 for o, _, dt, _ in layout)
    fresh = arena.clone()
    back = graphs._unflatten(flat, graphs._unpack(fresh, layout))
    got, want = [], []
    graphs._flatten(back, got)
    graphs._flatten(tree, want)
    assert back[2] is None and isinstance(back[1][0], tuple) and isinstance(back[3][0], dict)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.untyped_storage().data_ptr() == fresh.untyped_storage().data_ptr()
    arena.zero_()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_counter_advance_repeats_what_the_capture_counted():
    before = graphs._snapshot()
    krans.LAUNCHES["encode_planes"] += 1
    krans.LAUNCH_SHAPES["encode_planes", (32, 128)] += 1
    tcodec.GMM_STATS["rows"] += 5
    delta = graphs._delta(before)
    graphs._restore(before)
    assert graphs._snapshot() == before
    graphs._advance(delta)
    graphs._advance(delta)
    assert krans.LAUNCHES["encode_planes"] == before[0]["encode_planes"] + 2
    assert krans.LAUNCH_SHAPES["encode_planes", (32, 128)] == \
        before[1].get(("encode_planes", (32, 128)), 0) + 2
    assert tcodec.GMM_STATS["rows"] == before[3]["rows"] + 10
    assert isinstance(krans.LAUNCH_SHAPES, collections.Counter)
    graphs._restore(before)


@pytest.mark.parametrize("family", FAMILIES)
def test_emulated_replay_equals_eager(emulated, family):
    """Eager, capturing, replaying: 1/1/1 in the counters, and each call's
    strings, symbols and JFIF bytes are those of the same call op by op;
    the mixture's row counts advance as they do op by op."""
    (x,) = _requests(1)
    codec, eager = _codec(family), _codec(family)
    eager._dispatch_graphs = lambda: None
    tcodec.reset_gmm_stats()
    want = [eager.compress(x) for _ in range(3)]
    rows = tcodec.GMM_STATS["rows"]
    tcodec.reset_wire_stats()
    tcodec.reset_gmm_stats()
    got = [codec.compress(x) for _ in range(3)]
    w = tcodec.WIRE_STATS
    assert (w["eager_dispatches"], w["graph_captures"], w["graph_replays"]) == (1, 1, 1)
    assert w["d2h_syncs"] == 3 and w["host_fallbacks"] == 0
    assert tcodec.GMM_STATS["rows"] == rows
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("family", ["hyres", "cheng2020-attn-gmm3"])
def test_emulated_stream_equals_sequential(emulated, family):
    xs = _requests(4)
    codec, eager = _codec(family), _codec(family)
    eager._dispatch_graphs = lambda: None
    for x in xs:
        codec.compress(x)  # the marks of every request
    seq = [eager.inference(x) for x in xs]
    tcodec.reset_wire_stats()
    for depth in (2, 3):
        outs = codec.inference_stream(xs, depth=depth)
        for a, b in zip(outs, seq):
            _same(a["compressed"], b["compressed"])
            assert torch.equal(a["x_hat"], b["x_hat"])
    assert tcodec.WIRE_STATS["graph_replays"] == 8


def _lower_plans(monkeypatch):
    """Speculative plans whose stream slices are empty, below every plane's
    stream: each speculative pull misses and re-pulls."""
    plan = tcodec.speculative_plan

    def low(sig, st):
        spec = plan(sig, st)
        return spec._replace(plans=tuple((lanes, 0, el) for lanes, _, el in spec.plans))

    monkeypatch.setattr(tcodec, "speculative_plan", low)


@pytest.mark.parametrize("family", FAMILIES)
def test_emulated_miss_repulls_the_request_own_bytes(emulated, family, monkeypatch):
    """A plan below the marks, captured: in a stream at depth 2 each request
    misses its plan and re-pulls from its own encoder outputs while the
    next request's replay has overwritten the graph's memory."""
    xs = _requests(3)
    codec, eager = _codec(family), _codec(family)
    eager._dispatch_graphs = lambda: None
    want = [eager.inference(x) for x in xs]
    for x in xs:
        codec.compress(x)
    _lower_plans(monkeypatch)
    codec.compress(xs[0])  # the lowered plan's capture
    tcodec.reset_wire_stats()
    outs = codec.inference_stream(xs, depth=2)
    w = tcodec.WIRE_STATS
    assert (w["d2h_syncs"], w["graph_replays"], w["host_fallbacks"]) == (6, 3, 0)
    for a, b in zip(outs, want):
        _same(a["compressed"], b["compressed"])


@pytest.mark.parametrize("family", ["hyres", "elic"])
def test_emulated_host_fallback_codes_the_request_own_symbols(emulated, monkeypatch, family):
    xs = _requests(3)
    codec = _codec(family)
    for x in xs + xs:
        codec.compress(x)  # the marks of every request, then the capture
    eager = _codec(family)
    eager._dispatch_graphs = lambda: None

    def overflow(enc):
        raise OverflowError("forced")

    monkeypatch.setattr(tcodec.DevicePlaneCoder, "frames_from_enc", staticmethod(overflow))
    want = [eager.compress(x) for x in xs]
    tcodec.reset_wire_stats()
    outs = codec.inference_stream(xs, depth=2)
    assert tcodec.WIRE_STATS["host_fallbacks"] == 3
    assert tcodec.WIRE_STATS["graph_replays"] == 3
    for a, b in zip(outs, want):
        assert a["strings"] == b["strings"]
        assert a["compressed"].get("jpeg_buffers") == b.get("jpeg_buffers")
