"""Shared helpers of the benchmark's tests: cells cut to a CPU-sized
request, and a skip for tests that need the card."""

from __future__ import annotations

import dataclasses

import pytest

from portbench.lib import spec

SMALL_SEED = 2 ** 31 + 17


def small_cell(name: str):
    """The cell with its traffic cut to what a CPU test can hold: 64x64
    requests on a 2x2 lattice, every request checked; 2 crops of 64x64."""
    cell = spec.resolve(spec.load_benchmark(), name)
    tr, limits = dict(cell.traffic), dict(cell.limits)
    if tr["loop"] == "train":
        tr.update(batch=2, crop=64, warmup_steps=1, trace_steps=1)
        # at 2 crops of 64x64 a larger share of a leaf's elements has a
        # round-off gradient, which Adam's first steps move by a whole step
        limits["delta_gap"] = 2e-3
    else:
        tr.update(shapes=[[64, 64]], grid=2, warmup_roundtrips=1, sample_every=1,
                  list_len=3, warmup_lists=1, trace_requests=1)
    return dataclasses.replace(cell, traffic=tr, limits=limits)


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
