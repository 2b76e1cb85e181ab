"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is a file of its own: ``configs/<config>.json`` (the sizes, as
``BENCHMARK.json``'s ``file`` says) with ``configs/<config>.py`` beside it
(how the program is built and the weights made or read),
``reference/<config>.py`` (the plain reference), ``traffic/<traffic>.json``
(the mix's parameters, read by ``lib/traffic.py``; its ``loop`` names
``loops/<loop>.py``, what the window drives) and ``limits/<cell>.json``
(the numbers that decide ``correct``). Each metric, end to end or per
layer, is ``metrics/<metric>.py``. Adding a cell, a loop or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str | None = None):
    """Import a file by path (names such as ``hyres-n128-m192-q1.py`` are
    not identifiers)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    key = name or "portbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files read. Raises KeyError for
    an unknown name and FileNotFoundError for a missing file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    config["name"] = cfg_entry["name"]
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def config_module(config: dict, root: Path = ROOT):
    return load_module(root / "portbench" / "configs" / f"{config['name']}.py")


def reference_module(config: dict, root: Path = ROOT):
    return load_module(root / "portbench" / "reference" / f"{config['name']}.py")


def loop_module(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "loops" / f"{name}.py")


def metric_module(name: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{name}.py")
