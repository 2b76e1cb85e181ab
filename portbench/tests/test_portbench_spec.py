"""BENCHMARK.json against the contract's shape, and every name it holds
resolved to its files."""

from __future__ import annotations

import json
import re

import pytest

from portbench.lib import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits: 2 + 14 * 24 runs, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (spec.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for name in CELLS:
        cell = spec.resolve(BENCH, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # a per-layer metric moves an end-to-end metric of its cell
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(BENCH, name)
    loop = spec.loop_module(cell.traffic["loop"]).Loop
    assert all(callable(getattr(loop, f)) for f in
               ("setup", "window", "slice", "work", "release", "check"))
    spec.config_module(cell.config)
    ref = spec.reference_module(cell.config)
    assert hasattr(ref, "Reference")
    assert cell.limits, "a cell has limits that decide correct"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_module(m["name"]).read)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.resolve(BENCH, "no.such-cell")


def test_config_files_hold_their_sizes():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert "assumed" in cfg and cfg["coder"] == "device"
        for k in c["reduced"]:
            assert NAME.match(k)
