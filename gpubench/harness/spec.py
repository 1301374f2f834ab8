"""Finding a cell's files by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; each is a data file of its own:

* ``gpubench/workloads/<cell>.json``: the driver kind, the load, the
  engine or loop options and the correctness limits;
* ``gpubench/configs/<config>.json``: the published sizes, the cut, and
  under ``port`` the ``TransformerConfig`` fields the port runs;
* ``gpubench/traffic/<traffic>.json``: the parameters the general
  generator (:mod:`gpubench.harness.traffic`) reads;
* ``gpubench/layer_metrics/<metric>.py``: one reader a per-layer metric.

Nothing here imports the port: the CPU tests and the no-JAX check read
these files without torch.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config_file(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic_file(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def workload_file(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """The ``read(records)`` function of ``layer_metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Metric:
    name: str
    unit: str
    source: str


@dataclass
class Cell:
    """One cell as the harness runs it: its entry in ``BENCHMARK.json``,
    its workload, configuration and traffic files, and the metrics it
    reports with ``--trace 0`` and with ``--trace 1``."""

    name: str
    entry: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell in ws


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(entries)})")
    entry = entries[name]
    wl = workload_file(name)
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(
        name=name, entry=entry, workload=wl,
        config=config_file(entry["config"]),
        traffic=traffic_file(entry["traffic"]),
        end_to_end=[Metric(m["name"], m["unit"], m["source"])
                    for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[Metric(m["name"], m["unit"], m["source"])
                   for m in bench["per_layer"] if _applies(m, name)],
    )
