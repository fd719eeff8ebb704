"""A benchmark cell and the files it is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  The
configuration is ``portbench/configs/<config>.json``, the mix
``portbench/traffic/<traffic>.json`` (its ``runner`` names
``portbench/runners/<runner>.py``, which also holds the faults the cell can
have, ``FAULTS``), the cell's output limits
``portbench/limits/<cell>.json``, and a per-layer metric's reader
``portbench/metrics/<metric>.py``.  A new cell, mix or metric is new files
and new entries; no existing file changes.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    device: Any
    bench: Dict[str, Any] = field(default_factory=dict)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def end_to_end(self):
        """The end-to-end metrics this cell reports: those without a
        ``workloads`` key and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self):
        """The per-layer metrics read in this cell: those that list it, and
        those without a ``workloads`` key whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in mine)]


def bench_json(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load(bench: Dict, workload: str, seed: int, device) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))
    return Cell(workload, w, config, traffic, {k: float(v) for k, v in limits["limits"].items()},
                int(seed), device, bench)


def runner_module(kind: str):
    return importlib.import_module(f"portbench.runners.{kind}")


def runner_class(kind: str):
    return runner_module(kind).Runner


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Runner ``kind``'s fault ``fault`` planted under its timed path: its
    module's ``FAULTS[fault]`` names the module's hook and the wrapper that
    goes there."""
    mod = runner_module(kind)
    hook, wrap = mod.FAULTS[fault]
    setattr(mod, hook, wrap)
    try:
        yield
    finally:
        setattr(mod, hook, None)


def reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read`` (names may hold dots)."""
    mod_name = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    if mod_name not in sys.modules:
        path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return sys.modules[mod_name].read


def read_metrics(cell: Cell, ctx: Dict) -> Dict[str, Dict[str, Any]]:
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer():
        v: Optional[float] = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
