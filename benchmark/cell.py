"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix, its reference and its metrics.

Everything that belongs to one configuration, mix or metric lives in files
of its own, found by the names ``BENCHMARK.json`` gives:

- ``benchmark/configs/<config>.json``: the model's configuration as it is
  run, the program's registry name, the serving geometry, the reference's
  name and the output check's limit;
- ``benchmark/traffic/<mix>.json``: the generator's parameters;
- ``benchmark/reference/<reference>.py``: the plain forward and its table of
  parameters;
- ``benchmark/metrics/<metric>.py``: a ``read(record)`` that returns the
  metric's value, or None where the run gave it nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    reference: object  # the reference module
    metrics: dict  # name → (entry in BENCHMARK.json, reader)
    end_to_end: list  # names of the end-to-end metrics this cell reports
    per_layer: list  # names of the per-layer metrics this cell reports


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(workload: str) -> Cell:
    root = ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
    metrics, e2e, layer = {}, [], []
    for kind, names in (("end_to_end", e2e), ("per_layer", layer)):
        for entry in bench[kind]:
            if _reports(entry, workload):
                path = root / "benchmark" / "metrics" / f"{entry['name']}.py"
                metrics[entry["name"]] = (entry, _module(path, f"bench_metric_{entry['name']}"))
                names.append(entry["name"])
    return Cell(workload, w["chips"], config, mix, reference, metrics, e2e, layer)
