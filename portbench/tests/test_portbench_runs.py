"""Whole runs on the CPU at a small size: the program against the plain
reference, the program's bfloat16 path as the control that must fail, the
faults that the comparison must catch, and the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.lib import harness, spec
from portbench.tests.conftest import SMALL_SEED, small_cell

ALLOWED = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(name, seconds=1.0, **kw):
    return harness.run(small_cell(name), SMALL_SEED, seconds, False, device_name="cpu",
                       log=lambda m: None, **kw)


@pytest.mark.parametrize("name", ["hyres.serve-seq", "hyres.serve-stream2", "elic.serve-seq",
                                  "hyres.train-recipe"])
def test_the_program_agrees_with_the_reference(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert list(r) == ALLOWED and list(r["checks"]) and r["attempted"] > 0
    e2e = {m["name"] for m in small_cell(name).end_to_end}
    assert set(r["metrics"]) == e2e


@pytest.mark.parametrize("name", ["hyres.serve-seq", "hyres.train-recipe"])
def test_the_bfloat16_program_fails(name):
    r = _run(name, compute_dtype=torch.bfloat16)
    assert not r["correct"], r["checks"]


class _Broken:
    """A codec whose timed path is broken underneath, one way."""

    def __init__(self, codec, how):
        self.codec, self.how = codec, how

    def compress(self, x):
        comp = self.codec.compress(x)
        if self.how == "symbols":  # a plane's symbols altered where they are produced
            comp["symbols"] = (comp["symbols"][0], comp["symbols"][1] + 1, *comp["symbols"][2:])
        return comp

    def decompress(self, comp):
        d = self.codec.decompress(comp)
        if self.how == "answer":  # the reconstruction altered where it is produced
            d = {**d, "x_hat": torch.clamp(d["x_hat"] + 1e-3, 0.0, 1.0)}
        return d

    def inference_stream(self, xs, depth=2):
        outs = []
        for x in xs:
            comp = self.compress(x)
            d = self.decompress(comp)
            outs.append({"compressed": comp, "symbols": d["symbols"], "x_hat": d["x_hat"]})
        return outs


@pytest.mark.parametrize("how", ["symbols", "answer"])
@pytest.mark.parametrize("name", ["hyres.serve-seq", "hyres.serve-stream2"])
def test_a_serving_fault_fails(name, how):
    r = _run(name, fault=lambda codec: _Broken(codec, how))
    assert not r["correct"], r["checks"]


def test_a_training_step_that_leaves_the_state_unchanged_fails():
    def frozen(step, state):
        def run(x, gen, nq):
            return {"loss": torch.zeros(())}
        return run

    r = _run("hyres.train-recipe", fault=frozen)
    assert not r["correct"] and r["checks"]["delta_gap"]["value"] > 0.5, r["checks"]


def test_a_training_step_on_half_the_batch_fails():
    def half(step, state):
        full = state.model.draw_noise

        def draw(shape, *args, **kwargs):  # the rows' own draws of the full batch
            n = full(shape, *args, **kwargs)
            h = shape[0]
            z = n["z"]
            return {"z": z.reshape(z.shape[0], 1, 2 * h, -1)[:, :, :h].reshape(z.shape[0], 1, -1),
                    **{k: v[:h] for k, v in n.items() if k != "z"}}

        state.model.draw_noise = draw

        def run(x, gen, nq):
            return step(x[: x.shape[0] // 2], gen, nq)
        return run

    r = _run("hyres.train-recipe", fault=half)
    assert not r["correct"], r["checks"]


def test_run_py_without_a_card_exits_nonzero_and_prints_no_result():
    root = spec.ROOT
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hyres.serve-seq",
                        "--seed", str(SMALL_SEED), "--seconds", "1", "--trace", "0"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_refuses_an_unknown_workload():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_the_result_line_is_json_with_checks_last():
    r = _run("hyres.serve-seq")
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["device"]["platform"] == "cpu"  # a CPU run never claims a device


@pytest.mark.cuda
def test_tf32_reference_in_the_programs_place_fails_on_the_card(cuda):
    from portbench import control

    cell = small_cell("hyres.serve-seq")
    nums = control.serve_control(cell, SMALL_SEED, 2, cuda)
    assert any(nums[k] > v for k, v in cell.limits.items()), nums
