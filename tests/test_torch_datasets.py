"""The port's data layer against the JAX package's, on the CPU: SubmapSdf3D,
the label masks and sphere tracing, utils/sample.py, the RGB-D and LiDAR
loaders on the on-disk fixtures that tests/test_dataset_formats.py writes,
the config registry's datasets, and the Newer College and ScanNet eval
helpers with their ICP.

Both packages read the same files and draw from numpy generators of the same
seed, so host arrays must be equal and float results agree to 1e-6.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import jax_arrays, jax_model, small_cfg
from miso_tpu import config as j_config
from miso_tpu.datasets import fastcamo as j_fastcamo
from miso_tpu.datasets import lidar as j_lidar
from miso_tpu.datasets import replica as j_replica
from miso_tpu.datasets import rgbd as j_rgbd
from miso_tpu.datasets import scannet as j_scannet
from miso_tpu.datasets.sdf_3d_submap import SubmapSdf3D as JSubmapSdf3D
from miso_tpu.datasets.sequence import orbit_trajectory
from miso_tpu.datasets.shapes import room_scene
from miso_tpu.native import TriangleMesh as JMesh
from miso_tpu.utils import ncd as j_ncd
from miso_tpu.utils import sample as j_sample
from miso_tpu.utils import scannet_meta as j_meta
from miso_tpu.utils import sdf as j_sdf
from miso_tpu_torch import config as t_config
from miso_tpu_torch.convert import grid_net_from_numpy
from miso_tpu_torch.datasets import fastcamo as t_fastcamo
from miso_tpu_torch.datasets import lidar as t_lidar
from miso_tpu_torch.datasets import replica as t_replica
from miso_tpu_torch.datasets import rgbd as t_rgbd
from miso_tpu_torch.datasets import scannet as t_scannet
from miso_tpu_torch.datasets.sdf_3d_submap import SubmapSdf3D
from miso_tpu_torch.native import TriangleMesh
from miso_tpu_torch.utils import ncd as t_ncd
from miso_tpu_torch.utils import sample as t_sample
from miso_tpu_torch.utils import scannet_meta as t_meta
from miso_tpu_torch.utils import sdf as t_sdf
from test_dataset_formats import (_depth_stack, _poses, _ring_cloud, _write_pcd_ascii,
                                  _write_pcd_binary)

def same_batch(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def same_poses(got_ds, ref_ds, n):
    for kf in range(n):
        for a, b in zip(got_ds.true_kf_pose_in_world(kf), ref_ds.true_kf_pose_in_world(kf)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got_ds.noisy_kf_pose_in_world(kf), ref_ds.noisy_kf_pose_in_world(kf)):
            np.testing.assert_array_equal(a, b)
    for kf in range(n - 1):
        np.testing.assert_array_equal(got_ds.get_odometry_at_pose(kf),
                                      ref_ds.get_odometry_at_pose(kf))


# ---------------------------------------------------------------------------
# SubmapSdf3D, the label masks, sphere tracing
# ---------------------------------------------------------------------------

def test_submap_sdf3d_matches_jax():
    """tests/test_datasets.py's SubmapSdf3D: the submap poses, bounds,
    keyframe map, frames and two batches from one numpy generator each."""
    verts, tris = room_scene(4.0, seed=0)
    kw = dict(nx=2, ny=1, frames_per_submap=3, frame_samples=512, frame_batchsize=256,
              trunc_dist=0.2, submap_std_rad=0.05, submap_std_meter=0.1, seed=0, width=32,
              height=24)
    ref = JSubmapSdf3D(JMesh(verts, tris), **kw)
    got = SubmapSdf3D(TriangleMesh(verts, tris), **kw)
    assert got.num_kfs == ref.num_kfs == 6
    for s in range(2):
        for a, b in zip(got.noisy_submap_pose(s) + got.true_submap_pose(s),
                        ref.noisy_submap_pose(s) + ref.true_submap_pose(s)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.submap_bound(s), ref.submap_bound(s))
    assert [got.submap_id_for_kf(k) for k in range(6)] == [ref.submap_id_for_kf(k)
                                                           for k in range(6)]
    same_poses(got, ref, 6)
    np.testing.assert_array_equal(got.sampled_points_at_kf(4), ref.sampled_points_at_kf(4))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    same_batch(got.sample(r1), ref.sample(r2))
    got.select_keyframes([1, 4])
    ref.select_keyframes([1, 4])
    same_batch(got.sample(r1), ref.sample(r2))


def test_label_masks_match_jax():
    gt = np.random.default_rng(1).normal(0, 0.3, (500, 1)).astype(np.float32)
    gt[:3, 0] = [0.15, -0.15, 0.0]
    for name in ("sign_mask_from_gt_sdf", "valid_mask_from_gt_sdf"):
        ref = np.asarray(getattr(j_sdf, name)(gt, trunc_dist=0.15))
        got = getattr(t_sdf, name)(torch.as_tensor(gt), trunc_dist=0.15)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_sphere_tracing_matches_jax():
    """tests/test_utils_misc.py's sphere, and rays from outside hitting and
    missing, against the JAX loop."""
    import jax.numpy as jnp

    r = np.random.default_rng(2)
    origins = np.concatenate([[[2.0, 0, 0], [0, 2.0, 0]], r.uniform(-3, 3, (40, 3))]
                             ).astype(np.float32)
    dirs = np.concatenate([-origins[:2], r.normal(size=(40, 3))]).astype(np.float32)
    ref_p, ref_h = j_sdf.sphere_tracing(
        lambda x: jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5, jnp.asarray(origins),
        jnp.asarray(dirs), max_iters=50, max_dist=6.0)
    got_p, got_h = t_sdf.sphere_tracing(
        lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True) - 0.5,
        torch.as_tensor(origins), torch.as_tensor(dirs), max_iters=50, max_dist=6.0)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    assert got_h[:2].all() and 0 < int(got_h.sum()) < len(origins)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got_p[:2].numpy(), axis=1), 0.5, atol=1e-3)


def sphere_grid_net(radius=0.6):
    """A small JAX GridNet whose decoder passes feature channel 0 of the
    coarse level through (tests/test_align_baselines.py's decoder), that
    channel a sphere's SDF at the cell centres; and its port twin."""
    import jax.numpy as jnp

    from test_align_baselines import _passthrough_decoder
    cfg = small_cfg()
    mj = jax_model(cfg, seed=3)
    b = np.asarray(cfg["grid"]["bound"], np.float32)
    feats = [np.asarray(f).copy() for f in mj.features]
    shape = feats[0].shape[:3]
    axes = [b[k, 0] + (np.arange(n) + 0.5) * (b[k, 1] - b[k, 0]) / n for k, n in enumerate(shape)]
    X = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    feats[0][..., 0] = np.linalg.norm(X - b.mean(1), axis=-1) - radius
    mj = mj.replace(features=tuple(jnp.asarray(f) for f in feats),
                    decoder=_passthrough_decoder(mj.decoder))
    return mj, grid_net_from_numpy(jax_arrays(mj), cfg, device="cpu"), b.mean(1)


def test_sphere_tracing_a_grid_net_matches_jax():
    """The sphere GridNet traced from a ring of points around it, some rays
    aimed past it, against the JAX loop."""
    import jax.numpy as jnp

    mj, m, c = sphere_grid_net()
    a = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    origins = (c + np.stack([1.1 * np.cos(a), 0.8 * np.sin(a), 0.2 * np.cos(3 * a)], 1)
               ).astype(np.float32)
    dirs = (c + np.stack([np.zeros_like(a), np.zeros_like(a), 0.9 * np.sin(2 * a)], 1)
            - origins).astype(np.float32)
    ref_p, ref_h = j_sdf.sphere_tracing(mj, jnp.asarray(origins), jnp.asarray(dirs),
                                        max_iters=30, max_dist=3.0)
    got_p, got_h = t_sdf.sphere_tracing(m, torch.as_tensor(origins), torch.as_tensor(dirs),
                                        max_iters=30, max_dist=3.0)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    assert 0 < int(got_h.sum()) < len(origins)                 # some hit, some miss
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# utils/sample.py
# ---------------------------------------------------------------------------

def sample_case():
    r = np.random.default_rng(4)
    H, W = 12, 16
    depth = r.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[0, :3] = 0.0
    depth[5, 5] = np.nan
    T = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    T[:, :3, 3] = r.normal(size=(20, 3))
    return depth, T, (W, H, 14.0, 13.0, 7.5, 5.5)


@pytest.mark.parametrize("depth_type", ["z", "euclidean"])
def test_ray_geometry_matches_jax(depth_type):
    depth, T, (W, H, fx, fy, cx, cy) = sample_case()
    for name, args in (("ray_dirs_C", (H, W, fx, fy, cx, cy, depth_type)),
                       ("pointcloud_from_depth", (depth, fx, fy, cx, cy, depth_type))):
        np.testing.assert_array_equal(getattr(t_sample, name)(*args),
                                      getattr(j_sample, name)(*args))
    dirs = j_sample.ray_dirs_C(H, W, fx, fy, cx, cy, depth_type).reshape(-1, 3)[:20]
    for a, b in zip(t_sample.origin_dirs_W(T, dirs), j_sample.origin_dirs_W(T, dirs)):
        np.testing.assert_array_equal(a, b)
    pc = j_sample.pointcloud_from_depth(depth, fx, fy, cx, cy, depth_type)
    np.testing.assert_array_equal(t_sample.estimate_pointcloud_normals(pc),
                                  j_sample.estimate_pointcloud_normals(pc))


def test_sampling_and_bounds_match_jax():
    depth, T, (W, H, fx, fy, cx, cy) = sample_case()
    rt, rj = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(t_sample.sample_pixels(rt, 5, 4, H, W), j_sample.sample_pixels(rj, 5, 4, H, W)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_sample.stratified_sample(rt, 0.1, 3.0, 20, 6),
                                  j_sample.stratified_sample(rj, 0.1, 3.0, 20, 6))
    dirs = j_sample.ray_dirs_C(H, W, fx, fy, cx, cy).reshape(-1, 3)[:20]
    d = depth.reshape(-1)[20:40]
    got = t_sample.sample_along_rays(rt, T, 0.1, d + 0.1, 6, 4, dirs, gt_depth=d)
    ref = j_sample.sample_along_rays(rj, T, 0.1, d + 0.1, 6, 4, dirs, gt_depth=d)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    pc, z = ref
    normals = np.tile([0.0, 0.0, -1.0], (20, 1)).astype(np.float32)
    for name, args in (("bounds_ray", (d, z, dirs)), ("bounds_pc", (pc, z, d)),
                       ("bounds_normal", (d, z, dirs, normals, 0.1))):
        np.testing.assert_array_equal(getattr(t_sample, name)(*args),
                                      getattr(j_sample, name)(*args))


# ---------------------------------------------------------------------------
# The RGB-D loaders
# ---------------------------------------------------------------------------

def test_synthetic_rgbd_matches_jax():
    """tests/test_datasets.py's SyntheticRgbd with pose and depth noise: the
    depth frames, poses and batches, with CLIP features."""
    verts, tris = room_scene(4.0, seed=0)
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, 4, look_at=[0, 0, -0.5], convention="opencv")
    kw = dict(width=32, height=24, n_rays=32, n_strat_samples=6, n_surf_samples=3,
              trunc_dist=0.2, depth_range=(0.07, 10.0), pose_std_rad=0.01,
              pose_std_meter=0.02, depth_noise_std=0.01, seed=1)
    ref = j_rgbd.SyntheticRgbd(JMesh(verts, tris), R, t, **kw)
    got = t_rgbd.SyntheticRgbd(TriangleMesh(verts, tris), R, t, **kw)
    for k in ("depth", "T_WC_gt", "T_WC", "dirs_C"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    same_poses(got, ref, 4)
    clip = np.random.default_rng(0).normal(size=(4, 6, 8, 5)).astype(np.float32)
    got.clip_features, ref.clip_features = clip, clip
    assert got.clip_dim == 5
    same_batch(got.sample(np.random.default_rng(2)), ref.sample(np.random.default_rng(2)))
    np.testing.assert_array_equal(got.sampled_points_at_kf(1), ref.sampled_points_at_kf(1))


def test_clip_feature_files_load_as_jax(tmp_path):
    """load_clip_features of an .npz, a .pt and a directory of per-frame
    files (numeric order)."""
    verts, tris = room_scene(3.0, seed=0)
    R, t = orbit_trajectory([0, 0, 0], 1.0, 1.0, 3, convention="opencv")
    ds = t_rgbd.SyntheticRgbd(TriangleMesh(verts, tris), R, t, width=16, height=12)
    feats = np.random.default_rng(1).normal(size=(3, 4, 5, 6)).astype(np.float32)
    np.savez(tmp_path / "clip.npz", clip_features=feats)
    torch.save({"clip_features": torch.from_numpy(feats)}, tmp_path / "clip.pt")
    (tmp_path / "frames").mkdir()
    for i in range(3):
        np.save(tmp_path / "frames" / f"frame_{[2, 10, 1][i]}.npy", feats[[1, 2, 0][i]])
    ref = j_rgbd.SyntheticRgbd(JMesh(verts, tris), R, t, width=16, height=12)
    for path in ("clip.npz", "clip.pt", "frames"):
        got = ds.load_clip_features(str(tmp_path / path), n_clip_rays=7)
        np.testing.assert_array_equal(got, ref.load_clip_features(str(tmp_path / path)))
        np.testing.assert_array_equal(got, feats)
    assert ds.n_clip_rays == 7


def write_frame_data(path, n, T, odometry=None, submaps=False):
    """tests/test_dataset_formats.py's frame_data.pt (and cam_poses_icp.npy,
    submaps.pt) fixture."""
    torch.save({"depth_batch": torch.from_numpy(_depth_stack(n)),
                "T_WC_batch": torch.from_numpy(T),
                "norm_batch": torch.zeros((n, 24, 32, 3))}, path / "frame_data.pt")
    if odometry is not None:
        np.save(path / "cam_poses_icp.npy", odometry)
    if submaps:
        torch.save({"submaps": torch.tensor([[0.0, 0.0, 1.0, 4.0, 4.0, 2.0],
                                             [0.0, 0.0, 2.0, 4.0, 4.0, 2.0]]),
                    "kframe_submap_assoc": torch.tensor([[0, 0], [0, 1], [1, 2], [1, 3]])},
                   path / "submaps.pt")
    (path / "info.txt").write_text(
        "fx_depth = 300.0\nfy_depth = 300.0\nmx_depth = 15.5\n"
        "my_depth = 11.5\ndepthWidth = 32\ndepthHeight = 24\n")


SAMPLE = {"n_rays": 16, "depth_range": (0.07, 8.0), "n_strat_samples": 5, "n_surf_samples": 3}


def scannet_cfg(path):
    return {"dataset": {"path": str(path), "intrinsics_file": str(path / "info.txt"),
                        "trunc_dist": 0.15}, "sample": SAMPLE}


def camera_cfg(path, **extra):
    return {"dataset": {"path": str(path), "camera": {"fx": 300, "fy": 300, "cx": 15.5,
                                                      "cy": 11.5}, **extra},
            "sample": SAMPLE}


def rgbd_fixture(tmp_path, name):
    """(config, port class, JAX class) of one preprocessed RGB-D loader on its
    fixture."""
    n = 4
    T = _poses(n)
    if name == "ScanNet":
        T_icp = T.copy()
        T_icp[:, :3, 3] += 0.01
        write_frame_data(tmp_path, n, T, odometry=T_icp, submaps=True)
        return scannet_cfg(tmp_path), t_scannet.ScanNet, j_scannet.ScanNet
    write_frame_data(tmp_path, n, T)
    if name == "ReplicaCAD":
        return camera_cfg(tmp_path), t_replica.ReplicaCAD, j_replica.ReplicaCAD
    return (camera_cfg(tmp_path, pose_noise_rad=0.02, pose_noise_meter=0.05),
            t_fastcamo.FastCaMo, j_fastcamo.FastCaMo)


def check_rgbd(got, ref):
    for k in ("depth", "T_WC_gt", "T_WC", "dirs_C"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert (got.fx, got.fy, got.cx, got.cy) == (ref.fx, ref.fy, ref.cx, ref.cy)
    same_poses(got, ref, got.num_kfs)
    same_batch(got.sample(np.random.default_rng(5)), ref.sample(np.random.default_rng(5)))


@pytest.mark.parametrize("name", ["ScanNet", "ReplicaCAD", "FastCaMo"])
def test_preprocessed_rgbd_loaders_match_jax(tmp_path, name):
    cfg, t_cls, j_cls = rgbd_fixture(tmp_path, name)
    got, ref = t_cls(cfg), j_cls(cfg)
    check_rgbd(got, ref)
    if name == "ScanNet":
        assert got.keyframe_to_submap == ref.keyframe_to_submap == [0, 0, 1, 1]
        np.testing.assert_array_equal(got.submap_bound(1, buffer=0.3),
                                      ref.submap_bound(1, buffer=0.3))
        np.testing.assert_array_equal(got.normals_all, ref.normals_all)
        got.simulate_noisy_poses(np.random.default_rng(7), 0.01, 0.05, anchor=1)
        ref.simulate_noisy_poses(np.random.default_rng(7), 0.01, 0.05, anchor=1)
        np.testing.assert_array_equal(got.T_WC, ref.T_WC)
        assert t_scannet.load_scannet_intrinsics(str(tmp_path / "info.txt")) == \
            j_scannet.load_scannet_intrinsics(str(tmp_path / "info.txt"))


def write_png_frames(root, n):
    from PIL import Image
    (root / "depth").mkdir()
    (root / "pose").mkdir()
    T = _poses(n)
    r = np.random.default_rng(8)
    for i in range(n):
        mm = (1000.0 * r.uniform(1.5, 2.5, (24, 32))).astype(np.uint16)
        mm[0, :4] = 0
        Image.fromarray(mm).save(root / "depth" / f"{i:04d}.png")
        np.savetxt(root / "pose" / f"{i:04d}.txt", T[i])


@pytest.mark.parametrize("kw", [dict(intrinsics=(300.0, 300.0, 15.5, 11.5)),
                                dict(frame_stride=2, max_frames=2, intrinsics_file="info"),
                                dict()], ids=["intrinsics", "stride_info_file", "default"])
def test_posed_sdf_rgbd_matches_jax(tmp_path, kw):
    """Raw 16-bit depth PNGs and pose files, with explicit, ScanNet-file and
    default intrinsics; normals from depth."""
    write_png_frames(tmp_path, 5)
    write_frame_data(tmp_path, 1, _poses(1))               # for info.txt
    if kw.get("intrinsics_file"):
        kw = dict(kw, intrinsics_file=str(tmp_path / "info.txt"))
    kw.update(n_rays=16, n_strat_samples=5, n_surf_samples=3)
    got, ref = t_rgbd.PosedSdfRgbd(str(tmp_path), **kw), j_rgbd.PosedSdfRgbd(str(tmp_path), **kw)
    check_rgbd(got, ref)
    np.testing.assert_array_equal(got.estimate_normals(1), ref.estimate_normals(1))


# ---------------------------------------------------------------------------
# LiDAR
# ---------------------------------------------------------------------------

def lidar_fixture(tmp_path):
    rng = np.random.default_rng(0)
    T_gt = _poses(3, step=0.5)
    T_init = T_gt.copy()
    T_init[:, :3, 3] += 0.02
    j_lidar.write_kitti_format_poses(tmp_path / "poses_gt.txt", T_gt)
    j_lidar.write_kitti_format_poses(tmp_path / "poses_init.txt", T_init)
    scans = tmp_path / "scans"
    scans.mkdir()
    _write_pcd_ascii(scans / "frame_000.pcd", _ring_cloud(rng))
    _write_pcd_binary(scans / "frame_001.pcd", _ring_cloud(rng))
    j_sdf.write_ply(str(scans / "frame_002.ply"), _ring_cloud(rng), np.zeros((0, 3), np.int32))
    return scans


def test_point_cloud_readers_match_jax(tmp_path):
    scans = lidar_fixture(tmp_path)
    for f in ("frame_000.pcd", "frame_001.pcd", "frame_002.ply"):
        p = str(scans / f)
        np.testing.assert_array_equal(t_lidar.load_point_cloud(p), j_lidar.load_point_cloud(p))
        if f.endswith(".pcd"):
            np.testing.assert_array_equal(t_lidar.read_pcd(p), j_lidar.read_pcd(p))


@pytest.mark.parametrize("kw", [dict(voxel_size=0.05, min_range=0.5, max_range=10.0, min_z=-2.0,
                                     adaptive_range=False),
                                dict(voxel_size=0.05, min_range=0.5, max_range=10.0,
                                     adaptive_range=True, surface_only=True)],
                         ids=["fixed_range", "adaptive_surface_only"])
def test_lidar_dataset_matches_jax(tmp_path, kw):
    scans = lidar_fixture(tmp_path)
    args = dict(lidar_folder=str(scans), pose_file_gt=str(tmp_path / "poses_gt.txt"),
                pose_file_init=str(tmp_path / "poses_init.txt"), frame_samples=128,
                frame_batchsize=64, seed=3, **kw)
    got, ref = t_lidar.PosedSdf3DLidar(**args), j_lidar.PosedSdf3DLidar(**args)
    assert got.num_kfs == ref.num_kfs == 3
    for f in range(3):
        np.testing.assert_array_equal(got.sampled_points_at_kf(f), ref.sampled_points_at_kf(f))
        for k in ref.frames[f]:
            np.testing.assert_array_equal(got.frames[f][k], ref.frames[f][k], err_msg=k)
    same_poses(got, ref, 3)
    same_batch(got.sample(np.random.default_rng(1)), ref.sample(np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# The config registry's datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["PosedSdf3DLidar", "ScanNet", "ReplicaCAD", "FastCaMo"])
def test_cfg_dataset_builds_item2_datasets(tmp_path, name):
    """cfg_dataset builds each from its fixture, as the JAX registry does."""
    if name == "PosedSdf3DLidar":
        scans = lidar_fixture(tmp_path)
        cfg = {"dataset": {"path": str(scans), "pose_gt": str(tmp_path / "poses_gt.txt"),
                           "pose_init": str(tmp_path / "poses_init.txt"),
                           "frame_samples": 128, "frame_batchsize": 64, "voxel_size": 0.05}}
    else:
        cfg = rgbd_fixture(tmp_path, name)[0]
    cfg["dataset"]["name"] = name
    got, ref = t_config.cfg_dataset(cfg), j_config.cfg_dataset(cfg)
    assert type(got).__name__ == type(ref).__name__ == name
    assert type(got).__module__.startswith("miso_tpu_torch.")
    same_poses(got, ref, got.num_kfs)
    same_batch(got.sample(np.random.default_rng(4)), ref.sample(np.random.default_rng(4)))


# ---------------------------------------------------------------------------
# Newer College and ScanNet eval helpers
# ---------------------------------------------------------------------------

def moved_box_meshes():
    """A room and the same room moved by a small rigid transform."""
    verts, tris = room_scene(3.0, seed=1)
    w = np.array([0.02, -0.015, 0.03])
    from scipy.spatial.transform import Rotation
    Rm = Rotation.from_rotvec(w).as_matrix()
    moved = (verts @ Rm.T + [0.05, -0.03, 0.02]).astype(np.float32)
    return (verts, tris), (moved, tris)


def test_ncd_helpers_match_jax(tmp_path):
    scans = lidar_fixture(tmp_path)
    cfg = {"dataset": {"path": str(scans), "pose_gt": str(tmp_path / "poses_gt.txt"),
                       "pose_init": str(tmp_path / "poses_init.txt")}}
    kw = dict(voxel_size=0.05, frame_samples=64, frame_batchsize=32)
    got, ref = t_ncd.create_ncd_dataset(cfg, **kw), j_ncd.create_ncd_dataset(cfg, **kw)
    for f in range(3):
        for k in ref.frames[f]:
            np.testing.assert_array_equal(got.frames[f][k], ref.frames[f][k], err_msg=k)
    (gv, gt_tris), (mv, m_tris) = moved_box_meshes()
    ref_points = JMesh(gv, gt_tris).sample_surface(20000, seed=5)
    got_m = t_ncd.evaluate_ncd_mesh(TriangleMesh(mv, m_tris), ref_points, n_points=20000)
    ref_m = j_ncd.evaluate_ncd_mesh(JMesh(mv, m_tris), ref_points, n_points=20000)
    assert got_m.keys() == ref_m.keys()
    for k in ref_m:
        np.testing.assert_allclose(got_m[k], ref_m[k], rtol=1e-6, atol=1e-6, err_msg=k)
    # The ICP took the motion out: the moved mesh scores as the unmoved one.
    floor = t_ncd.evaluate_ncd_mesh(TriangleMesh(gv, gt_tris), ref_points, n_points=20000)
    assert got_m["Chamfer_L1 (cm)"] < 1.1 * floor["Chamfer_L1 (cm)"]


def test_scannet_meta_matches_jax(tmp_path):
    scenes_t, scenes_j = t_meta.scannet_scenes(str(tmp_path)), j_meta.scannet_scenes(str(tmp_path))
    assert {k: vars(v) for k, v in scenes_t.items()} == {k: vars(v) for k, v in scenes_j.items()}
    scene = scenes_t["0207_00"]
    os.makedirs(scene.path)
    write_frame_data(Path(scene.path), 4, _poses(4))
    (Path(scene.intrinsics_file)).write_text((Path(scene.path) / "info.txt").read_text())
    cfg = {"dataset": {"trunc_dist": 0.15}, "sample": SAMPLE,
           "model": {"grid": {}, "pose": {}}}
    got = t_meta.create_scannet_dataset(cfg, scene)
    ref = j_meta.create_scannet_dataset(cfg, scenes_j["0207_00"])
    assert got.anchor_kfs == ref.anchor_kfs == [0, 35]
    check_rgbd(got, ref)
    (gv, gt_tris), (mv, m_tris) = moved_box_meshes()
    got_T = t_meta.align_mesh_to_gt(TriangleMesh(mv, m_tris), TriangleMesh(gv, gt_tris),
                                    n_points=20000)
    ref_T = j_meta.align_mesh_to_gt(JMesh(mv, m_tris), JMesh(gv, gt_tris), n_points=20000)
    np.testing.assert_allclose(got_T[0], ref_T[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_T[1:], ref_T[1:], rtol=1e-6)
