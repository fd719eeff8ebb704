"""The program's hierarchical latent alignment, ``Fuser.align()`` with the
quad SLAM configuration's ``align:`` section, against the benchmark's plain
reference (``portbench/reference/align.py``) on the CPU: the alignment
cell's own set-up and check (``portbench/runners/align.py``) at a small size
(``portbench/tests/align_cells.py``: 3 submaps of 6×6×4 and 30×30×20 cells,
seeded, every submap but the first perturbed).  The reference follows the
first 3 steps of the program's call from its recorded pair context, and
tests its alignment coordinates."""
from __future__ import annotations

import pytest
import torch

from portbench.reference import align as reference
from portbench.tests.align_cells import small_runner


@pytest.fixture(scope="module")
def aligned():
    r = small_runner()
    got = r.program_readings()
    return r, got, r.reference_readings("fp32")


def test_the_call_keeps_every_pair_and_runs_the_configured_steps(aligned):
    r, got, ref = aligned
    assert got["pairs"] == ref["pairs"] == [(0, 1), (0, 2), (1, 2)]
    assert got["rows"] == 4 and got["level"] == 1
    assert r.steps_per_call == r.cell.config["align"]["level_iters"] + 1 == 51


def test_step_losses_match_the_reference(aligned):
    # float32 sums over about 1.5e3 masked points and 8 channels in another
    # order (segment sums against a per-pair sum): a few ulps, read 2.4e-7.
    r, got, ref = aligned
    assert r.compare(got, ref)["loss_gap"] < 2e-6


def test_first_pose_gradient_matches_the_reference(aligned):
    # The same sums through the points' gradient, the by-id gathers'
    # backward and the so(3) exponential, against autograd of the plain
    # version, as a vector per leaf: read 1.1e-6.
    r, got, ref = aligned
    assert r.compare(got, ref)["grad_gap"] < 1e-5
    for name, g in got["grads"].items():
        assert float(g[0].abs().max()) == 0.0 and float(g[3:].abs().max()) == 0.0, name


def test_pose_change_after_three_steps_matches_the_reference(aligned):
    # Three Adam steps of lr 1e-2 from the gradients above; Adam's
    # normalisation carries their relative gap into the step: read 4.3e-6.
    r, got, ref = aligned
    assert r.compare(got, ref)["change_gap"] < 4e-5


def test_selected_coordinates_pass_the_vertex_and_threshold_test(aligned):
    r, got, ref = aligned
    assert ref["select_gap"] == 0.0 and r.compare(got, ref)["select_gap"] == 0.0
    inp = r._inputs()
    submaps = [inp.tables(s) for s in range(inp.submaps)]
    bounds = inp.local.expand(inp.submaps, 3, 2)
    cap = int(r.align_cfg["max_points"])
    coords, valid = got["coords"].clone(), got["valid"].clone()
    # Half a fine cell off a centre, and a valid flag dropped: each one row.
    coords[1, 5, 0] += 0.1
    valid[2, 7, 0] = 0.0
    fails, rows = reference.selection_failures(submaps, bounds, coords, valid, 1, cap)
    assert fails == 2 and rows == coords.shape[0] * coords.shape[1]


def test_a_whole_call_moves_the_poses_toward_the_truth(aligned):
    r, _, _ = aligned
    r._call()
    err = r.pose_error()
    assert err["now"]["deg_mean"] < 0.5 * err["start"]["deg_mean"]
    assert err["now"]["m_mean"] < 0.5 * err["start"]["m_mean"]
