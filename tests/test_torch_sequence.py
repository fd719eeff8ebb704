"""The port's synthetic SLAM sequence and ray casting against the JAX
package's.

The same mesh, trajectory and seed give the same frames, odometry and noisy
poses in both packages (both draw with numpy in the same order and cast rays
with the same native runtime), so they are compared for equality; the device
pool against the frames it holds.
"""
import numpy as np
import pytest
import torch

from miso_tpu.datasets import sequence as j_seq
from miso_tpu.datasets.shapes import room_scene as j_room_scene
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu_torch.datasets import sequence as t_seq
from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.datasets.shapes import room_scene
from miso_tpu_torch.native import TriangleMesh

KW = dict(frame_samples=2**10, frame_batchsize=128, trunc_dist=0.3, near_surface_std=0.1,
          odom_std_rad=0.002, odom_std_meter=0.005, pose_std_rad=0.01, pose_std_meter=0.02)


@pytest.fixture(scope="module")
def meshes():
    v, t = room_scene(4.0, seed=0)
    vj, tj = j_room_scene(4.0, seed=0)
    np.testing.assert_array_equal(v, vj)
    return TriangleMesh(v, t), JMesh(vj, tj)


def test_trajectories_match_jax():
    for conv in ("opengl", "opencv"):
        a = t_seq.orbit_trajectory([0, 0, 0], 1.8, 1.4, 9, look_at=[0, 0, -0.5],
                                   convention=conv)
        b = j_seq.orbit_trajectory([0, 0, 0], 1.8, 1.4, 9, look_at=[0, 0, -0.5],
                                   convention=conv)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    a = t_seq.circuit_trajectory(10.0, 1.5, 17, laps=1.2, seed=3, wobble=0.3)
    b = j_seq.circuit_trajectory(10.0, 1.5, 17, laps=1.2, seed=3, wobble=0.3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _pair(meshes, pattern):
    if pattern == "pinhole":
        R, t = t_seq.orbit_trajectory([0, 0, 0], 1.4, 1.2, 5, look_at=[0, 0, -0.5])
        kw = dict(KW, behind_surface_n=1)
    else:
        R, t = t_seq.circuit_trajectory(1.0, 1.2, 5, seed=0)
        kw = dict(KW, scan_pattern="lidar", width=64, height=16, max_range=3.5,
                  voxel_size=0.2)
    return (t_seq.SdfSequence(meshes[0], R, t, seed=4, **kw),
            j_seq.SdfSequence(meshes[1], R, t, seed=4, **kw))


@pytest.mark.parametrize("pattern", ["pinhole", "lidar"])
def test_sequence_matches_jax(meshes, pattern):
    s, sj = _pair(meshes, pattern)
    assert isinstance(s, SubmapDataset)
    assert s.num_kfs == sj.num_kfs == 5
    for f, fj in zip(s.frames, sj.frames):
        assert f.keys() == fj.keys()
        for k in f:
            np.testing.assert_array_equal(f[k], fj[k])
    for k in range(s.num_kfs):
        for a, b in zip(s.noisy_kf_pose_in_world(k), sj.noisy_kf_pose_in_world(k)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(s.true_kf_pose_in_world(k), sj.true_kf_pose_in_world(k)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(s.sampled_points_at_kf(k), sj.sampled_points_at_kf(k))
    for k in range(s.num_kfs - 1):
        np.testing.assert_array_equal(s.get_odometry_at_pose(k), sj.get_odometry_at_pose(k))
    s.select_keyframes([3, 1, 1])
    sj.select_keyframes([3, 1, 1])
    a = s.sample(np.random.default_rng(9))
    b = sj.sample(np.random.default_rng(9))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["coords_frame"].shape == (3 * KW["frame_batchsize"], 3)


def test_device_pool(meshes):
    s, _ = _pair(meshes, "pinhole")
    s.select_keyframes([2, 0, 2])
    pool, sel, n_rows, B = s.device_pool("cpu")
    assert B == KW["frame_batchsize"]
    assert sel.tolist() == [2, 0, 2] and sel.dtype == torch.int64
    n_max = max(f["points_frame"].shape[0] for f in s.frames)
    names = {"coords_frame": "points_frame", "sdf": "sdf", "sdf_valid": "valid",
             "sdf_signs": "signs"}
    for out, src in names.items():
        assert tuple(pool[out].shape[:2]) == (s.num_kfs, n_max)
        assert pool[out].dtype == torch.float32
    for kf in range(s.num_kfs):
        n = s.frames[kf]["points_frame"].shape[0]
        loaded = kf in (0, 2)
        assert int(n_rows[kf]) == (n if loaded else 0)
        for out, src in names.items():
            if loaded:
                np.testing.assert_array_equal(pool[out][kf, :n].numpy(), s.frames[kf][src])
            assert not pool[out][kf, n if loaded else 0:].any()
    # A later selection adds its keyframes to the same buffers.
    s.select_keyframes([4])
    pool2, sel2, n_rows2, _ = s.device_pool("cpu")
    assert all(pool2[k] is pool[k] for k in pool) and n_rows2 is n_rows
    assert sel2.tolist() == [4] and int(n_rows[4]) == s.frames[4]["points_frame"].shape[0]
    with pytest.raises(ValueError, match="pool"):
        s.device_pool("meta")


def test_device_pool_defaults_to_the_card(meshes):
    s, _ = _pair(meshes, "pinhole")
    if torch.cuda.is_available():
        assert s.device_pool()[1].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            s.device_pool()


def test_native_queries_match_jax(meshes):
    m, mj = meshes
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(m.unsigned_distance(pts), mj.unsigned_distance(pts))
    origins = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    dirs = rng.standard_normal((400, 3)).astype(np.float32)
    t, tri = m.raycast(origins, dirs)
    tj, trij = mj.raycast(origins, dirs)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(tri, trij)
    assert 0.2 < (t > 0).mean() < 1.0    # both hits and misses
    np.testing.assert_array_equal(m.face_normals, mj.face_normals)
    assert m.area == mj.area
    with pytest.raises(ValueError):
        m.raycast(origins, dirs[:10])
