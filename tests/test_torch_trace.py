"""The port's spans (``hyres_tpu_torch/utils/trace.py``) on the CPU.

``span`` opens a ``torch.profiler.record_function`` range only while a
profiler runs. Under ``torch.profiler`` a HyRES roundtrip (the trained
artifact on a 128x128 crop, as ``tests/test_torch_wire.py``) and an ELIC
roundtrip (N=16, M=24, groups 4/4/8/8 on 64x64, as
``tests/test_torch_elic.py``) on the device coder's plain path, and a
small ``make_train_step`` step, emit their layers' spans, each under
exactly one root; bytes, symbols and reconstructions are the same with the
profiler on and off.
"""

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from hyres_tpu_torch.models import ElicCodec, LightWeightELIC
from hyres_tpu_torch.models import codec as tcodec
from hyres_tpu_torch.models import hyres as thyres
from hyres_tpu_torch.nn import init_parameters
from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
from hyres_tpu_torch.utils import trace
from hyres_tpu_torch.utils.png import load_image

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
ROOTS = {"compress.dispatch", "compress.finish", "decompress.dispatch", "decompress.wait",
         "train.step"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _program_spans(prof):
    """[(name, [names of the program roots around it, innermost first])]
    of every ``hyres.*`` range, in start order, from ``cpu_parent``."""
    out = []
    events = [e for e in prof.events() if e.name.startswith("hyres.")]
    for e in sorted(events, key=lambda e: e.time_range.start):
        roots, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("hyres.") and p.name[6:] in ROOTS:
                roots.append(p.name[6:])
            p = p.cpu_parent
        out.append((e.name[6:], roots))
    return out


def _by_root(spans):
    """Checks the nesting (every span under exactly one root, no root
    under another) and returns [(root, Counter of the spans under it)]
    in order."""
    groups = []
    for name, roots in spans:
        if name in ROOTS:
            assert roots == [], (name, roots)
            groups.append((name, Counter()))
        else:
            assert len(roots) == 1, (name, roots)
            assert groups and groups[-1][0] == roots[0], (name, roots)
            groups[-1][1][name] += 1
    return groups


def test_span_opens_nothing_without_a_profiler(monkeypatch):
    """Off, ``span`` tests the profiler's flag and nothing else: a
    ``record_function`` that raises is never called. Under a profiler the
    same span reaches it."""
    def boom(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    with trace.span("model.params"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert trace.span("a") is trace.span("b")  # one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function called"):
            with trace.span("model.params"):
                pass


def test_span_is_a_named_range_under_the_profiler():
    def run():
        with trace.span("coder.frame"):
            with trace.span("coder.unframe"):
                torch.ones(2).add_(1)

    _, prof = _profiled(run)
    names = [e.name for e in prof.events() if e.name.startswith("hyres.")]
    assert sorted(names) == ["hyres.coder.frame", "hyres.coder.unframe"]
    inner = next(e for e in prof.events() if e.name == "hyres.coder.unframe")
    assert inner.cpu_parent.name == "hyres.coder.frame"


def _equal_outputs(a, b):
    for k in ("strings", "jpeg_buffers", "shape", "size"):
        if k in a[0]:
            assert a[0][k] == b[0][k], k
    for s, t in zip(a[0]["symbols"], b[0]["symbols"]):
        assert torch.equal(s, t)
    for s, t in zip(a[1]["symbols"], b[1]["symbols"]):
        assert torch.equal(s, t)
    assert torch.equal(a[1]["x_hat"], b[1]["x_hat"])


def test_hyres_roundtrip_spans():
    """A HyRES device-coder roundtrip: the compress's two roots, the
    decompress's two, each layer's spans under them, one pull wait in the
    compress's finish; outputs equal with the profiler on and off."""
    img = load_image(IMAGE)
    x = torch.from_numpy(np.array(img[:, 256:384, 128:256]))
    tc = thyres.HyresCodec.from_artifact(ARTIFACT, device="cpu", coder="device")

    def roundtrip():
        c = tc.compress(x)
        return c, tc.decompress(c)

    off = roundtrip()  # the first call's full-cap pull; the profiled one is speculative
    tcodec.reset_wire_stats()
    on, prof = _profiled(roundtrip)
    assert tcodec.WIRE_STATS["host_fallbacks"] == 0
    _equal_outputs(off, on)
    groups = _by_root(_program_spans(prof))
    assert [r for r, _ in groups] == ["compress.dispatch", "compress.finish",
                                      "decompress.dispatch", "decompress.wait"]
    (_, cd), (_, cf), (_, dd), (_, dw) = groups
    assert cd == Counter({"model.jpeg": 1, "model.analysis": 1, "model.params": 2,
                          "coder.encode": 1, "coder.pull": 1})
    assert cf == Counter({"coder.pull_wait": 1, "coder.frame": 3, "jfif.assemble": 1})
    assert dd == Counter({"jfif.parse": 1, "coder.unframe": 3, "coder.upload": 2,
                          "coder.decode": 3, "model.params": 2, "model.jpeg": 1,
                          "model.synthesis": 1, "model.refine": 1})
    assert dw == Counter()


def _elic():
    model = LightWeightELIC(16, 24, (4, 4, 8, 8))
    init_parameters(model, torch.Generator().manual_seed(0))
    tc = ElicCodec(model.eval(), coder="device", device="cpu")
    tc.update(force=True)
    return tc


def _elic_crops(n):
    img = load_image(IMAGE)
    return [torch.from_numpy(np.array(img[:, 96 * k:96 * k + 64, 160 * k:160 * k + 64]))
            for k in range(1, n + 1)]


def test_elic_roundtrip_spans():
    """An ELIC device-coder roundtrip: the slice stages as ``model.params``,
    one K3 encode, one pull wait, a frame and an unframe and a decode a
    plane."""
    tc = _elic()
    x = _elic_crops(1)[0]

    def roundtrip():
        c = tc.compress(x)
        return c, tc.decompress(c["strings"], c["shape"], c["size"])

    off = roundtrip()
    tcodec.reset_wire_stats()
    on, prof = _profiled(roundtrip)
    assert tcodec.WIRE_STATS["host_fallbacks"] == 0
    _equal_outputs(off, on)
    groups = _by_root(_program_spans(prof))
    assert [r for r, _ in groups] == ["compress.dispatch", "compress.finish",
                                      "decompress.dispatch", "decompress.wait"]
    (_, cd), (_, cf), (_, dd), _ = groups
    planes = 2 * 4 + 1
    assert cd == Counter({"model.analysis": 1, "model.params": 1 + 3 * 4,
                          "coder.encode": 1, "coder.pull": 1})
    assert cf == Counter({"coder.pull_wait": 1, "coder.frame": planes})
    assert dd == Counter({"coder.unframe": planes, "coder.upload": 1,
                          "coder.decode": planes, "model.params": 1 + 3 * 4,
                          "model.synthesis": 1})


def test_inference_stream_spans_nest_under_one_root():
    """The depth-2 stream (``CodecBase.inference_stream``, which HyRES
    shares) interleaves requests' halves: each span still sits under
    exactly one root, and each decode's wait is a root of its own."""
    tc = _elic()
    xs = _elic_crops(3)
    off = tc.inference_stream(xs, 2)
    on, prof = _profiled(lambda: tc.inference_stream(xs, 2))
    for a, b in zip(off, on):
        assert a["strings"] == b["strings"]
        assert torch.equal(a["x_hat"], b["x_hat"])
    roots = Counter(r for r, _ in _by_root(_program_spans(prof)))
    assert roots == Counter({"compress.dispatch": 3, "compress.finish": 3,
                             "decompress.dispatch": 3, "decompress.wait": 3})


def test_train_step_spans():
    """A small recipe step: ``train.step`` with the forward, the backward
    and the optimizer's parts under it; the step's result is the same
    with the profiler on and off."""
    def state():
        model = init_parameters(thyres.ResidualJPEGCompression(8, 12, 1),
                                torch.Generator().manual_seed(3))
        main, aux = configure_optimizers(model, 1e-4, 1e-3, 1.0)
        return create_train_state(model, main, aux)

    x = torch.from_numpy(np.array(load_image(IMAGE)[:, :64, :64]))
    x = torch.cat([x, x.flip(2)])
    s_off, s_on = state(), state()
    m_off = make_train_step(s_off, 0.015)(x, torch.Generator().manual_seed(0), True)
    m_on, prof = _profiled(
        lambda: make_train_step(s_on, 0.015)(x, torch.Generator().manual_seed(0), True))
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for a, b in zip(s_off.model.parameters(), s_on.model.parameters()):
        assert torch.equal(a, b)
    groups = _by_root(_program_spans(prof))
    assert [(r, dict(c)) for r, c in groups] == [("train.step", {
        "model.forward": 1, "model.backward": 1, "optim.guard": 1, "optim.clip": 1,
        "optim.adam": 1, "optim.aux": 1, "optim.select": 1})]
