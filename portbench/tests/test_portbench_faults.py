"""A whole run of each cell, driven on the CPU at a small size past the
harness's look for a card, comes out correct as the program is, and not
correct with each fault the cell can have planted under its timed path
(each runner's ``FAULTS``): a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced.  The
control, the reference in TF32 in the program's place, is not correct
either.  The cells' own limits decide."""
from __future__ import annotations

import contextlib
import copy
import json
import os
import time

import pytest
import torch

from portbench import run
from portbench.harness import cell as cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 31 + 2 ** 20 + 7


def small_map_cell(name):
    c = cells.load(cells.bench_json(), name, SEED, torch.device("cpu"))
    c.config = copy.deepcopy(c.config)
    g = c.config["model"]["grid"]
    lo = [b[0] for b in g["bound"]]
    base = float(g["base_cell_size"])
    g["bound"] = [[l, l + base * (n - 0.01)] for l, n in zip(lo, (3, 4, 2))]
    c.config["table_shapes"] = [[3, 4, 2], [int(3 * g["per_level_scale"]),
                                            int(4 * g["per_level_scale"]),
                                            int(2 * g["per_level_scale"])]]
    c.config["train"]["batch_size"] = 4096
    c.config["model"]["pose"]["num_poses"] = 7
    return c


def drive(cell, fault=None, seconds=0.2):
    with cells.planted(cell.traffic["runner"], fault) if fault else contextlib.nullcontext():
        result, checks = run.run_cell(cell, seconds, False, time.perf_counter())
    return result, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("name", ["scannet.map_step", "ncd_quad.map_step"])
@pytest.mark.parametrize("fault", [None, *cells.runner_module("map_step").FAULTS])
def test_map_cell_comes_out_correct_only_without_a_fault(name, fault):
    result, checks = drive(small_map_cell(name), fault)
    assert result["correct"] is (fault is None), checks
    json.dumps(result)


@pytest.mark.parametrize("name", ["scannet.map_step", "ncd_quad.map_step"])
def test_map_cell_control_is_not_correct(name):
    cell = small_map_cell(name)
    r = cells.runner_class("map_step")(cell)
    gaps = r.compare(r.reference_readings("tf32"), r.reference_readings("fp32"))
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scannet.map_step", "ncd_quad.map_step"])
def test_map_cell_control_is_not_correct_at_the_cells_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from portbench import readings
    readings.main(["--workload", name, "--seeds", "3", "4", "5", "--control", "3"])
