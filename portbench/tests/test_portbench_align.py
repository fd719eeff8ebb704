"""The alignment cell, ``ncd_quad_atlas.align``, on the CPU at a small size
(``align_cells.py``): a whole run comes out correct as the program is, and
not correct with each fault the cell can have planted under its timed path
(the runner's ``FAULTS``: poses left unchanged, half the pair rows, the
loss altered); the control, the reference in TF32 in the program's place,
is not correct either; the cell's files resolve; its readers pick their
work from synthetic Chrome traces and return nothing without the program's
spans; the slot-id counts by hand."""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import atlasgen, cell as cells, trace
from portbench.roofline import counts, slot_counts
from portbench.tests.align_cells import NAME, small_align_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
METRICS = ("pose_backward_ms.align", "slot_interp_roofline.align",
           "align_precompute_ms.align", "align_step_launches")


@pytest.mark.parametrize("fault", [None, *cells.runner_module("align").FAULTS])
def test_align_cell_comes_out_correct_only_without_a_fault(fault):
    cell = small_align_cell()
    with cells.planted("align", fault) if fault else contextlib.nullcontext():
        result, checks = run.run_cell(cell, 0.2, False, time.perf_counter())
    assert result["correct"] is (fault is None), checks
    assert result["attempted"] >= 1 and result["metrics"]["map_points_per_s"]["value"] > 0
    json.dumps(result)


def test_align_cell_control_is_not_correct():
    cell = small_align_cell()
    r = cells.runner_class("align")(cell)
    r.setup()
    r.release()
    gaps = r.compare(r.reference_readings("tf32"), r.reference_readings("fp32"))
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps


def test_align_cell_resolves_to_its_files():
    bench = cells.bench_json()
    cell = cells.load(bench, NAME, 1, torch.device("cpu"))
    assert {m["name"] for m in cell.per_layer()} == set(METRICS)
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap", "select_gap"}
    cfg, entry = cell.config, {c["name"]: c for c in bench["configs"]}["ncd_quad_atlas"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    g = cfg["model"]["grid"]
    cells_m = atlasgen.cell_sizes(g)
    assert [atlasgen.grid_shape(cfg["system"]["submap_local_bound"], c)
            for c in cells_m] == cfg["table_shapes"] == [[90, 90, 20], [450, 450, 100]]
    assert [atlasgen.grid_shape(g["bound"], c) for c in cells_m] == cfg["world_table_shapes"]
    assert atlasgen.submap_count(cfg) == 10 and cfg["system"]["submap_capacity"] == 8
    assert cfg["align"] == {"level_iters": 50, "finetune_iters": 50, "learning_rate": 0.01,
                            "loss_type": "L2", "stability_thresh": 0.0,
                            "subsample_points": None, "latent_levels": [1],
                            "skip_finetune": True, "pose_reg_weight": 0.0, "verbose": False}


def test_keyframes_and_perturbations_follow_the_mix():
    cell = small_align_cell()
    inp = atlasgen.AtlasInputs(cell.config, cell.traffic, cell.seed, "cpu")
    assert [len(r) for r, _ in inp.keyframes] == [4, 4, 4]
    for Rsk, tsk in inp.keyframes:                   # each submap's first keyframe is its anchor
        np.testing.assert_allclose(Rsk[0], np.eye(3), atol=1e-6)
        np.testing.assert_allclose(tsk[0], 0.0, atol=1e-5)
    c = (np.einsum("sij,sij->s", inp.R_start, inp.R_true) - 1.0) / 2.0
    deg = np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))
    m = np.linalg.norm(inp.t_start - inp.t_true, axis=-1)
    assert deg[0] == 0.0 and m[0] == 0.0
    assert (deg[1:] <= cell.traffic["max_deg"] + 1e-3).all() and deg[1:].max() > 0.0
    assert (m[1:] <= cell.traffic["max_m"] + 1e-6).all() and m[1:].max() > 0.0
    t = inp.tables(0)
    assert [list(x.shape[:3]) for x in t] == cell.config["table_shapes"]
    assert float(t[1].abs().max()) > 0.0 and float(t[1][0, 0, 0].abs().max()) == 0.0


# -- the readers on synthetic traces ------------------------------------------

MAIN, BACKWARD = 1, 2
STEPS = 3


def _x(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, tid=MAIN):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, corr)


def _events(spans: bool):
    """One call: a precompute kernel, then STEPS steps of 100 us, each
    launching the slot-id forward on the caller's thread and, on the
    backward thread, the points' gradient inside ``_GridInterpPerPointBackward``
    and a sort and a scatter inside ``IndexBackward0``."""
    ev = [_x(trace.WINDOW, "user_annotation", 0, 1000)]
    if spans:
        ev += [_x("miso.align", "user_annotation", 5, 990),
               _x("miso.align.precompute", "user_annotation", 10, 80),
               _x("miso.align.steps", "user_annotation", 100, 3 + 100 * STEPS)]
    ev += [_launch(1, 20), _x("void norm_kernel", "kernel", 30, 40, 7, 1)]
    for k in range(STEPS):
        t, c = 100 + 100 * k, 10 * (k + 1)
        ev += [_launch(c + 1, t + 5), _launch(c + 2, t + 40, BACKWARD),
               _launch(c + 3, t + 50, BACKWARD), _launch(c + 4, t + 60, BACKWARD),
               _x("autograd::engine::evaluate_function: _GridInterpPerPointBackward", "cpu_op",
                  t + 38, 6, BACKWARD),
               _x("autograd::engine::evaluate_function: IndexBackward0", "cpu_op", t + 48, 20,
                  BACKWARD)]
        ev += [_x("void grid_interp_forward_kernel<4, float>(MttInterpArgs)", "kernel",
                  t + 10, 4, 7, c + 1),
               _x("void grid_interp_points_grad_kernel<float>(MttInterpArgs)", "kernel",
                  t + 42, 6, 7, c + 2),
               _x("void cub::DeviceRadixSortOnesweepKernel", "kernel", t + 52, 5, 7, c + 3),
               _x("void indexing_backward_kernel_small_stride<float>", "kernel", t + 62, 20, 7,
                  c + 4)]
    return ev


def _ctx(tmp_path, spans: bool):
    path = tmp_path / f"trace_{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return {"trace": trace._parse(str(path), 1), "steps_per_call": STEPS,
            "counts": {"slot_interp_least_s": 2e-6}}


def test_align_readers_pick_their_work(tmp_path):
    ctx = _ctx(tmp_path, spans=True)
    read = {m: cells.reader(m)(ctx) for m in METRICS}
    assert read["pose_backward_ms.align"] == pytest.approx(0.025)   # 5 + 20 us a step
    assert read["align_step_launches"] == pytest.approx(4.0)
    assert read["align_precompute_ms.align"] == pytest.approx(0.040)
    # 2 us of least time over the forward's 4 and the points' gradient's 6 us.
    assert read["slot_interp_roofline.align"] == pytest.approx(20.0)


def test_align_readers_without_the_spans_return_nothing(tmp_path):
    ctx = _ctx(tmp_path, spans=False)
    for m in METRICS:
        assert cells.reader(m)(ctx) is None
        assert cells.reader(m)({}) is None


# -- the slot-id counts ----------------------------------------------------------

def test_slot_touched_rows_count_each_slot_apart():
    bounds = torch.tensor([[[0.0, 4.0]] * 3, [[0.0, 2.0]] * 3])
    sizes = torch.tensor([[4, 4, 4], [2, 2, 2]], dtype=torch.int32)
    x = torch.tensor([[1.75, 1.75, 1.75], [1.8, 1.8, 1.8], [1.75, 1.75, 1.75]])
    ids = torch.tensor([0, 0, 1])
    # Slot 0: {1, 2}^3; slot 1 (2 cells of 1 m a side): the point at 1.75
    # reads cells {1, 2}^3 of which only (1, 1, 1) lies in its logical size.
    assert slot_counts.touched_rows(ids, x, bounds, sizes, (4, 4, 4)) == 9


def test_slot_counts_by_hand():
    f = slot_counts.forward(n=10, fdim=4, rows=7)
    assert f == {"flops_simt": 2 * 8 * 4 * 10, "nbytes": 16 * 10 + 7 * 4 * 4 + 4 * 4 * 10}
    b = slot_counts.points_backward(n=10, fdim=4, rows=7)
    assert b == {"flops_simt": 2 * (32 + 24) * 10,
                 "nbytes": 16 * 10 + 4 * 4 * 10 + 7 * 4 * 4 + 12 * 10}
    assert counts.least_s(**f) == pytest.approx(f["nbytes"] / counts.PEAKS["hbm_bytes_per_s"])
