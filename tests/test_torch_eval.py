"""The port's trajectory metrics and the SE(3) helpers that tracking and
evaluation call, against the JAX package's.

Umeyama alignment runs in float64 on both sides (to 1e-12); the metrics and
the float32 SE(3) helpers to 1e-5 relative (sums in another order), but for
angles from the arccos of a float32 trace near 1, where one ulp of the trace
moves a 1-degree angle by 1.5e-4 degrees: 1e-3 degrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import close, t
from miso_tpu.ops import se3 as j_se3
from miso_tpu.utils import eval as j_eval
from miso_tpu_torch.ops import se3
from miso_tpu_torch.utils import eval as t_eval

TOL = dict(rtol=1e-5, atol=1e-6)


def _poses(n, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    R = np.asarray(j_se3.so3_exp(jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))))
    tr = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, tr
    return T


def test_umeyama_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    R = np.asarray(j_se3.so3_exp(jnp.asarray([0.3, -0.2, 0.5])), np.float64)
    dst = 1.7 * src @ R.T + [0.5, -1.0, 2.0] + 1e-3 * rng.normal(size=(50, 3))
    for with_scale in (False, True):
        got = t_eval.umeyama_alignment(src, dst, with_scale)
        ref = j_eval.umeyama_alignment(src, dst, with_scale)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    R_s, t_s, s = t_eval.umeyama_alignment(src, dst, True)
    np.testing.assert_allclose(R_s, R, atol=1e-3)
    assert s == pytest.approx(1.7, rel=1e-3)


@pytest.mark.parametrize("form", ["poses", "positions", "unaligned", "two_poses"])
def test_trajectory_error_matches_jax(form):
    gt = _poses(12, 1)
    est = gt.copy()
    rng = np.random.default_rng(2)
    est[:, :3, 3] += rng.normal(scale=0.02, size=(12, 3)).astype(np.float32)
    drift = np.asarray(j_se3.so3_exp(jnp.asarray([0.0, 0.02, 0.01])))
    est[:, :3, :3] = drift @ est[:, :3, :3]
    align = form != "unaligned"
    if form == "positions":
        est, gt = est[:, :3, 3], gt[:, :3, 3]
    if form == "two_poses":
        est, gt = est[:2], gt[:2]
    got = t_eval.trajectory_error(est, gt, align=align)
    ref = j_eval.trajectory_error(est, gt, align=align)
    assert got.keys() == ref.keys()
    for k in got:
        tol = dict(abs=1e-3) if k == "rot_rmse_deg" else dict(rel=1e-5, abs=1e-6)
        assert got[k] == pytest.approx(ref[k], **tol), k


def test_se3_helpers_match_jax():
    T1, T2 = _poses(7, 3), _poses(7, 4)
    R1, R2, t1, t2 = T1[:, :3, :3], T2[:, :3, :3], T1[:, :3, 3], T2[:, :3, 3]
    for name in ("so3_relative_angle", "rotation_rmse_deg", "rotation_mean_error_deg"):
        close(getattr(se3, name)(t(R1), t(R2)), getattr(j_se3, name)(R1, R2), TOL)
    for name in ("translation_rmse", "translation_mean_error"):
        close(getattr(se3, name)(t(t1), t(t2)), getattr(j_se3, name)(t1, t2), TOL)
    dr, dt = se3.get_pose_correction(t(R1), t(t1), t(R2), t(t2))
    drj, dtj = j_se3.get_pose_correction(R1, t1, R2, t2)
    close(dr, drj, dict(rtol=1e-4, atol=1e-5))
    close(dt, dtj, TOL)
    Ra, ta = se3.apply_pose_correction(t(R1), t(t1), dr, dt)
    close(Ra, R2, dict(rtol=0, atol=5e-5))     # log then exp of up to pi in float32
    for name in ("transform_poses_to", "transform_poses_from"):
        got = getattr(se3, name)(t(R2), t(t2), t(R1[0]), t(t1[0]))
        ref = getattr(j_se3, name)(R2, t2, R1[0], t1[0])
        for a, b in zip(got, ref):
            close(a, b, TOL)
    close(se3.pose_matrix(t(R1[2]), t(t1[2])), j_se3.pose_matrix(R1[2], t1[2]), TOL)
    close(se3.aabb(t(t2), 0.5), j_se3.aabb(t2, 0.5), TOL)


def test_metrics_of_an_empty_mesh_raise():
    """A mesh with no triangles (an observed query that masks everything)
    raises in sample_surface instead of crashing the native sampler."""
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    empty = TriangleMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    with pytest.raises(ValueError, match="no triangles"):
        empty.sample_surface(10)
    gt = TriangleMesh(*room_scene(3.0))
    with pytest.raises(ValueError, match="no triangles"):
        t_eval.mesh_reconstruction_metrics(empty, gt, n_points=100)
