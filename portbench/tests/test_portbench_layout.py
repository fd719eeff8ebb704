"""BENCHMARK.json against the benchmark's contract, and every cell against the
files it is found by.  CPU only; run with ``python -m pytest portbench/tests``."""
from __future__ import annotations

import json
import math
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head",
               "expansion", "feature_dim", "experts_per_token")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_resolve_and_reduce_no_width():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p.rstrip("/") + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and not any(w in k for w in WIDTH_WORDS)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from portbench.harness import cell as cells
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    c = cells.load(BENCH, cell, 1, "cpu")
    runner = cells.runner_class(c.traffic["runner"])
    names = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    assert set(runner.end_to_end) == names - {"setup_s"}
    assert c.per_layer(), "every cell reports a per-layer metric"
    for m in c.per_layer():
        assert callable(cells.reader(m["name"]))
    assert c.limits and all(math.isfinite(v) and v >= 0 for v in c.limits.values())


def test_config_and_traffic_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_keys_units_and_bounds():
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells_)) <= cells_
    setup = {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]
    assert "workloads" not in setup and setup["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", ())) <= cells_
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_roofline_or_mfu_share_reads_percent():
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
