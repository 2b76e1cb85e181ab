"""The ``cheng2020.serve-seq`` cell on the CPU at the small size of
``conftest.small_cell``: the program agrees with the plain reference, and
the two controls of its limits fail, the program's bfloat16 path and rows
built from one component. At 64x64 a request's y payload is a few hundred
bytes, of which each plane's frame (6 bytes and a 4-byte state a lane) is
a fifth, so ``gmm_rate_gap`` is judged here at a limit between the sound
run's reading (0.21) and the control's (0.33)."""

from __future__ import annotations

import dataclasses
import importlib.util

import pytest
import torch

from portbench.lib import harness, spec
from portbench.tests.conftest import SMALL_SEED, small_cell

CELL = "cheng2020.serve-seq"


def _one_component():
    path = spec.ROOT / "scripts" / "cheng_gmm_one_component.py"
    s = importlib.util.spec_from_file_location("cheng_gmm_one_component", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.one_component


def _run(trace=False, **kw):
    cell = small_cell(CELL)
    cell = dataclasses.replace(cell, limits={**cell.limits, "gmm_rate_gap": 0.27})
    return harness.run(cell, SMALL_SEED, 1.0, trace, device_name="cpu", log=lambda m: None, **kw)


def test_the_program_agrees_with_the_reference():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"requests_unchecked", "decoded_vs_coded",
                                "symbol_mismatch_share", "recon_rmse", "gmm_rate_gap"}
    assert r["metrics"]["gmm_escape_share"]["value"] < 1.0


@pytest.mark.parametrize("how", ["bf16", "one-component"])
def test_a_control_fails(how):
    kw = ({"compute_dtype": torch.bfloat16} if how == "bf16"
          else {"fault": _one_component()})
    r = _run(**kw)
    assert not r["correct"], r["checks"]
