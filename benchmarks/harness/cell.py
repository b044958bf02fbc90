"""A cell's files, found by the names in ``BENCHMARK.json``.

The harness knows no cell, configuration, traffic mix, route or metric by
name: ``workloads`` names a cell's configuration and traffic; the
configuration is the file that ``configs`` gives for it; the traffic is
``benchmarks/traffic/<traffic>.json``; its route is
``benchmarks/routes/<route>.py``; each metric is read by
``benchmarks/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["BENCH_DIR", "REPO", "Cell", "load_cell", "load_reader",
           "load_route"]

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((REPO / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    return Cell(
        name=name,
        chips=int(cell["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def _load_file(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def load_reader(metric: str) -> Callable[[Dict], object]:
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    module = _load_file(BENCH_DIR / "metrics" / f"{metric}.py",
                        "bench_metric_" + metric.replace(".", "_"))
    return module.read


def load_route(route: str):
    return _load_file(BENCH_DIR / "routes" / f"{route}.py", f"bench_route_{route}")
