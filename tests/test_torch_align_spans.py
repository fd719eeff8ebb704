"""The alignment's spans and counters
(``align/miso.py::align_multiple_submaps_hierarchical``), on the CPU with
the alignment cell's small atlas (``portbench/tests/align_cells.py``).

* Under ``torch.profiler`` the call is one ``miso.align`` span holding, in
  order, ``miso.align.precompute``, ``miso.align.intersect``,
  ``miso.align.ctx`` and ``miso.align.steps``, and the steps' ``miso.step``
  spans lie inside ``miso.align.steps``.
* The counters read the last call: live pairs, padded rows, points a step
  and steps; the flat pair loss gathers two pose rows a padded pair row.
* With no profiler recording the call opens no span.
"""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from miso_tpu_torch.align import miso as align
from portbench.tests.align_cells import small_runner
from test_torch_profiling import annotations

PHASES = ["miso.align.precompute", "miso.align.intersect", "miso.align.ctx",
          "miso.align.steps"]


@pytest.fixture(scope="module")
def runner():
    return small_runner(points=128)


def test_align_spans_nest(runner, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner._call()
    ann = annotations(prof, tmp_path)
    (outer,) = [a for a in ann if a[0] == "miso.align"]
    phases = [a for a in ann if a[0].startswith("miso.align.")]
    assert [a[0] for a in phases] == PHASES
    assert all(outer[1] <= a[1] and a[2] <= outer[2] for a in phases)
    steps = phases[-1]
    inner = [a for a in ann if a[0] == "miso.step"]
    assert len(inner) == runner.steps_per_call == 51
    assert all(steps[1] <= a[1] and a[2] <= steps[2] for a in inner)
    for a, b in zip(phases, phases[1:]):
        assert a[2] <= b[1], (a, b)


def test_align_counters_read_the_last_call(runner):
    runner._call()
    fn = align.align_multiple_submaps_hierarchical
    assert (fn.pairs, fn.pair_rows, fn.steps) == (3, 4, 51)
    assert fn.points_per_step == 3 * int(runner.align_cfg["max_points"])
    assert runner.pair_points == fn.points_per_step


def test_flat_loss_gathers_two_pose_rows_a_pair_row(runner):
    align.FlatPairLoss.pose_rows = 0
    runner._call()
    assert align.FlatPairLoss.pose_rows == 2 * align.align_multiple_submaps_hierarchical.pair_rows
    assert align.FlatPairLoss.pose_rows == 8


def test_align_without_a_profiler_opens_no_span(runner, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    runner._call()
    assert not torch.equal(runner.atlas.params.sub_trans_corr, runner.start[1])
