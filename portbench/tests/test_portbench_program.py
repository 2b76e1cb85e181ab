"""The program's spans in a hand-made trace (``lib/program.py``), and
``lib/trace.py read_profile`` unmoved by them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.lib import program
from portbench.lib.trace import read_profile


class _Ev:
    def __init__(self, name, start, end, kind, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = SimpleNamespace(name=kind)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _serve_events():
    """A compress and a decompress (times in us): the benchmark's spans,
    the program's, and four stretches of device work."""
    cpu = [("pb.compress", 0, 1000), ("pb.compress.dispatch", 0, 600),
           ("pb.compress.finish", 600, 1000), ("pb.decompress", 1000, 2000),
           ("hyres.compress.dispatch", 10, 590), ("hyres.model.analysis", 20, 200),
           ("hyres.coder.encode", 300, 400), ("hyres.coder.pull", 400, 450),
           ("hyres.compress.finish", 610, 990), ("hyres.coder.pull_wait", 620, 900),
           ("hyres.jfif.assemble", 920, 980),
           ("hyres.decompress.dispatch", 1010, 1990), ("hyres.model.synthesis", 1100, 1500)]
    dev = [("conv", 100, 300), ("void encode_kernel(EncArgs)", 350, 380),
           ("Memcpy DtoH", 700, 880), ("conv", 1200, 1700)]
    return ([_Ev(n, s, e, "CPU") for n, s, e in cpu]
            + [_Ev(n, s, e, "CUDA") for n, s, e in dev])


def test_idle_is_given_to_the_innermost_program_span():
    p = program.read(_serve_events())
    r = p["roots"]
    # idle: 0-100, 300-350, 380-700, 880-1200, 1700-2000
    assert r["compress.dispatch"]["idle_s"] == {"host": pytest.approx(150e-6),
                                                "model": pytest.approx(80e-6),
                                                "coder": pytest.approx(120e-6)}
    assert r["compress.finish"]["idle_s"] == {"host": pytest.approx(100e-6),
                                              "coder": pytest.approx(100e-6)}
    assert r["decompress.dispatch"]["idle_s"] == {"host": pytest.approx(380e-6),
                                                  "model": pytest.approx(100e-6)}
    assert r["compress.finish"]["idle_by_span"] == {"compress.finish": pytest.approx(40e-6),
                                                    "coder.pull_wait": pytest.approx(100e-6),
                                                    "jfif.assemble": pytest.approx(60e-6)}
    assert r["compress.dispatch"]["spans"] == {"compress.dispatch": 1, "model.analysis": 1,
                                               "coder.encode": 1, "coder.pull": 1}
    assert r["compress.finish"]["spans"] == {"compress.finish": 1, "coder.pull_wait": 1,
                                             "jfif.assemble": 1}
    assert {k: v["n"] for k, v in r.items()} == {"compress.dispatch": 1, "compress.finish": 1,
                                                 "decompress.dispatch": 1}
    # the benchmark's spans: idle inside them, and the part under a program span
    assert p["bench"]["compress"] == {"idle_s": pytest.approx(590e-6),
                                      "covered_s": pytest.approx(550e-6)}
    assert p["bench"]["compress.dispatch"] == {"idle_s": pytest.approx(370e-6),
                                               "covered_s": pytest.approx(350e-6)}
    assert p["bench"]["decompress"] == {"idle_s": pytest.approx(500e-6),
                                        "covered_s": pytest.approx(480e-6)}
    got = {k: fn(p) for k, fn in program.METRICS["serve_seq"].items()}
    assert got == {"idle_ms.compress.model": pytest.approx(0.08),
                   "idle_ms.compress.coder": pytest.approx(0.22),
                   "idle_ms.compress.host": pytest.approx(0.25),
                   "idle_ms.decompress.model": pytest.approx(0.1),
                   "idle_ms.decompress.coder": 0.0,
                   "idle_ms.decompress.host": pytest.approx(0.38),
                   "pulls_per_compress": 1.0}
    cov = program.coverage(p, program.ENCLOSING["serve_seq"])
    assert cov["compress"]["covered_pct"] == pytest.approx(100 * 550 / 590)
    assert cov["decompress"]["covered_pct"] == pytest.approx(96.0)


def test_a_miss_counts_two_pulls_and_a_stream_counts_images():
    cpu = [("pb.stream", 0, 400),
           ("hyres.compress.dispatch", 0, 100), ("hyres.compress.dispatch", 100, 200),
           ("hyres.compress.finish", 200, 300), ("hyres.coder.pull_wait", 210, 220),
           ("hyres.coder.pull_wait", 230, 250), ("hyres.compress.finish", 300, 400),
           ("hyres.coder.pull_wait", 310, 320)]
    p = program.read([_Ev(n, s, e, "CPU") for n, s, e in cpu])
    assert program.pulls_per_compress(p) == 1.5
    got = {k: fn(p) for k, fn in program.METRICS["serve_stream"].items()}
    # no device work: all 400 us idle, 40 under the pull waits, over 2 images
    assert got == {"idle_ms.stream.model": 0.0, "idle_ms.stream.coder": pytest.approx(0.02),
                   "idle_ms.stream.host": pytest.approx(0.18)}
    assert program.coverage(p, ("stream",))["stream"]["covered_pct"] == pytest.approx(100.0)


def test_training_groups_and_an_empty_trace():
    cpu = [("pb.train", 0, 1000), ("pb.train.step", 0, 1000), ("hyres.train.step", 0, 1000),
           ("hyres.model.forward", 0, 300), ("hyres.model.backward", 300, 600),
           ("hyres.optim.guard", 600, 700), ("hyres.optim.adam", 700, 800),
           ("hyres.optim.select", 900, 950)]
    dev = [("conv", 50, 250), ("wgrad", 300, 550), ("adam", 720, 780)]
    p = program.read([_Ev(n, s, e, "CPU") for n, s, e in cpu]
                     + [_Ev(n, s, e, "CUDA") for n, s, e in dev])
    got = {k: fn(p) for k, fn in program.METRICS["train"].items()}
    # model: 0-50, 250-300, 550-600; optim: 600-720, 780-800, 900-950
    assert got == {"idle_ms.train.model": pytest.approx(0.15),
                   "idle_ms.train.optimizer": pytest.approx(0.19)}
    assert p["roots"]["train.step"]["idle_s"]["host"] == pytest.approx(150e-6)
    # the parent's program opens no span: every reader returns None
    empty = program.read(_serve_events()[:4] + _serve_events()[-4:])
    for fns in program.METRICS.values():
        assert all(fn(empty) is None for fn in fns.values())


def test_device_side_program_ranges_move_nothing():
    """The ranges that Kineto draws on the device's timeline for the
    program's spans (user annotations) count as no device work, in
    ``read_profile``'s keys and in the program's split alike."""
    base = _serve_events()
    drawn = [_Ev("hyres.compress.dispatch", 10, 590, "CUDA", annotation=True),
             _Ev("hyres.model.analysis", 20, 200, "CUDA", annotation=True),
             _Ev("hyres.decompress.dispatch", 1010, 1990, "CUDA", annotation=True)]
    assert read_profile(_Prof(base + drawn), 0.003) == read_profile(_Prof(base), 0.003)
    assert program.read(base + drawn) == program.read(base)
    # named as the program names them, they count as no device work even unflagged
    unflagged = [_Ev(e.name, e.time_range.start, e.time_range.end, "CUDA") for e in drawn]
    assert program.read(base + unflagged) == program.read(base)
