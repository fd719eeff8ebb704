"""LiDAR SLAM dataset (port of ``miso_tpu/datasets/lidar.py``, host numpy as
there): KITTI-format ground-truth and initial pose files, per-frame point
clouds (.pcd ascii or binary, .ply), an adaptive voxel downsample and a
range and height crop (``ops/pooling.py``), then PIN-SLAM-style samples
along each ray: surface (sdf 0), near-surface Gaussian, free space (sign +1)
and behind the surface (sign -1), with PIN-SLAM's distance weights.
Samples are kept in frame coordinates; batches follow the
``SubmapDataset`` schema.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.ops.pooling import crop_points, voxel_down_sample_indices


def read_kitti_format_poses(path: str) -> List[np.ndarray]:
    """A file of 3x4 pose rows -> list of 4x4 matrices."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.strip().split()]
            if len(vals) < 12:
                raise ValueError("Not a KITTI-format pose file")
            T = np.eye(4)
            T[:3, :4] = np.asarray(vals[:12]).reshape(3, 4)
            poses.append(T)
    return poses


def write_kitti_format_poses(path: str, poses: np.ndarray):
    """(N, 4, 4) -> one row of the 3x4 top per pose."""
    flat = np.asarray(poses)[:, :3, :].reshape(len(poses), -1)
    np.savetxt(path, flat)


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD reader (ascii + binary, xyz fields)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"DATA")
    header = data[:header_end].decode("ascii", "ignore").splitlines()
    fields, sizes, types, counts = [], [], [], []
    npts = 0
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "FIELDS":
            fields = parts[1:]
        elif parts[0] == "SIZE":
            sizes = [int(x) for x in parts[1:]]
        elif parts[0] == "TYPE":
            types = parts[1:]
        elif parts[0] == "COUNT":
            counts = [int(x) for x in parts[1:]]
        elif parts[0] == "POINTS":
            npts = int(parts[1])
    data_line_end = data.find(b"\n", header_end)
    mode = data[header_end:data_line_end].decode().split()[1]
    body = data[data_line_end + 1:]
    tmap = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4",
            ("U", 4): "<u4", ("U", 1): "u1", ("I", 1): "i1", ("U", 2): "<u2",
            ("I", 2): "<i2"}
    if not counts:
        counts = [1] * len(fields)
    if mode == "ascii":
        arr = np.fromstring(body.decode("ascii"), sep=" ").reshape(npts, -1)
        idx = {f: i for i, f in enumerate(fields)}
        return np.stack([arr[:, idx["x"]], arr[:, idx["y"]], arr[:, idx["z"]]],
                        -1).astype(np.float32)
    dtype = np.dtype([(f, tmap[(t, s)], (c,)) for f, t, s, c in
                      zip(fields, types, sizes, counts)])
    arr = np.frombuffer(body, dtype=dtype, count=npts)
    return np.stack([arr["x"].reshape(npts), arr["y"].reshape(npts),
                     arr["z"].reshape(npts)], -1).astype(np.float32)


def load_point_cloud(path: str) -> np.ndarray:
    """(N, 3) float32 points of a .pcd or .ply scan."""
    if path.endswith(".pcd"):
        return read_pcd(path)
    from miso_tpu_torch.utils.sdf import read_ply
    verts, _ = read_ply(path)
    return verts


class PosedSdf3DLidar(SubmapDataset):
    def __init__(self, cfg: Optional[Dict] = None, lidar_folder=None,
                 pose_file_gt=None, pose_file_init=None, num_frames=None,
                 frame_samples=5000, frame_batchsize=1024, near_surface_n=2,
                 near_surface_std=0.25, free_space_n=1, behind_surface_n=1,
                 trunc_dist=0.5, distance_std=0.0, min_dist_ratio=0.3,
                 adaptive_range=True, voxel_size=0.08, min_z=-3.0,
                 max_z=100.0, min_range=2.75, max_range=60.0, seed=0,
                 surface_only=False):
        if cfg is not None:
            d = cfg["dataset"]
            lidar_folder = d["path"]
            pose_file_gt = d["pose_gt"]
            pose_file_init = d["pose_init"]
            num_frames = d.get("num_frames")
            frame_samples = d.get("frame_samples", frame_samples)
            frame_batchsize = d.get("frame_batchsize", frame_batchsize)
            trunc_dist = d.get("trunc_dist", trunc_dist)
            voxel_size = d.get("voxel_size", voxel_size)
        self.frame_samples = frame_samples
        self.frame_batchsize = frame_batchsize
        self.near_surface_n = 0 if surface_only else near_surface_n
        self.near_surface_std = near_surface_std
        self.free_space_n = 0 if surface_only else free_space_n
        self.behind_surface_n = 0 if surface_only else behind_surface_n
        self.trunc_dist = trunc_dist
        self.distance_std = distance_std
        self.min_dist_ratio = min_dist_ratio
        self.max_range = max_range
        # PIN-SLAM Table II: behind-surface range 4 sigma.
        self.max_range_behind_surface = 4 * near_surface_std
        self._rng = np.random.default_rng(seed)
        self._selected: Optional[List[int]] = None

        poses_gt = read_kitti_format_poses(pose_file_gt)
        poses_init = read_kitti_format_poses(pose_file_init)
        n = min(len(poses_gt), len(poses_init))
        files = sorted(f for f in os.listdir(lidar_folder)
                       if f.endswith(".pcd") or f.endswith(".ply"))
        if num_frames is not None:
            files = files[:num_frames]
        n = min(n, len(files))
        assert n > 0, "No usable frames"
        self._num_frames = n
        self.R_gt = np.stack([poses_gt[i][:3, :3] for i in range(n)]).astype(np.float32)
        self.t_gt = np.stack([poses_gt[i][:3, 3] for i in range(n)]).astype(np.float32)
        self.R_init = np.stack([poses_init[i][:3, :3] for i in range(n)]).astype(np.float32)
        self.t_init = np.stack([poses_init[i][:3, 3] for i in range(n)]).astype(np.float32)

        # Load + downsample + crop each scan (sdf_3d_lidar.py:96-162).
        self.scans_local = []
        for i in range(n):
            pts = load_point_cloud(os.path.join(lidar_folder, files[i]))
            if adaptive_range and len(pts):
                hi = pts.max(0)
                lo = pts.min(0)
                r = max(min(abs(hi[0]), abs(lo[0])), min(abs(hi[1]), abs(lo[1])))
                crop_max = min(max_range, 2.0 * r)
            else:
                crop_max = max_range
            voxel = (crop_max / max_range) * voxel_size
            if voxel > 0 and len(pts):
                pts = pts[voxel_down_sample_indices(pts, voxel)]
            pts, _ = crop_points(pts, None, min_z, max_z, min_range, crop_max)
            self.scans_local.append(pts.astype(np.float32))
        self._sample_frames()

    # -- PIN-SLAM sampling (sdf_3d_lidar.py:214-347) -----------------------
    def distance_weight(self, dists, scale=0.8):
        return 1 + scale * 0.5 - (dists / self.max_range) * scale

    def _sample_frames(self):
        rng = self._rng
        self.frames = []
        for f in range(self._num_frames):
            pts_local = self.scans_local[f]
            n_surf = len(pts_local)
            assert n_surf > 0, f"frame {f} empty after crop"
            keep = min(self.frame_samples, n_surf)
            pts_local = pts_local[rng.permutation(n_surf)[:keep]]
            dist = np.maximum(np.linalg.norm(pts_local, axis=1, keepdims=True), 1e-6)
            rdir = pts_local / dist
            w_surf = self.distance_weight(dist)
            parts = [(pts_local, np.zeros((keep, 1), np.float32), w_surf,
                      np.ones((keep, 1), np.float32), np.zeros((keep, 1), np.float32))]
            if self.near_surface_n:
                rd = np.repeat(dist, self.near_surface_n, 0)
                rr = np.repeat(rdir, self.near_surface_n, 0)
                disp = rng.standard_normal((keep * self.near_surface_n, 1)).astype(np.float32) \
                    * self.near_surface_std
                pts = rr * (rd + disp)
                parts.append((pts, -disp, self.distance_weight(rd),
                              np.ones_like(disp), np.zeros_like(disp)))
            if self.free_space_n:
                rd = np.repeat(dist, self.free_space_n, 0)
                rr = np.repeat(rdir, self.free_space_n, 0)
                ratio = self.min_dist_ratio + rng.uniform(
                    size=(keep * self.free_space_n, 1)) * (0.99 - self.min_dist_ratio)
                disp = np.minimum((ratio - 1.0) * rd, -self.trunc_dist).astype(np.float32)
                pts = rr * (rd + disp)
                parts.append((pts, -disp, self.distance_weight(rd + disp),
                              np.zeros_like(disp), np.ones_like(disp)))
            if self.behind_surface_n:
                rd = np.repeat(dist, self.behind_surface_n, 0)
                rr = np.repeat(rdir, self.behind_surface_n, 0)
                disp = (self.trunc_dist + rng.uniform(
                    size=(keep * self.behind_surface_n, 1))
                    * (self.max_range_behind_surface)).astype(np.float32)
                pts = rr * (rd + disp)
                parts.append((pts, -disp, self.distance_weight(rd),
                              np.zeros_like(disp), -np.ones_like(disp)))
            self.frames.append({
                "points_frame": np.concatenate([p[0] for p in parts]).astype(np.float32),
                "sdf": np.concatenate([p[1] for p in parts]).astype(np.float32),
                "weights": np.concatenate([p[2] for p in parts]).astype(np.float32),
                "valid": np.concatenate([p[3] for p in parts]).astype(np.float32),
                "signs": np.concatenate([p[4] for p in parts]).astype(np.float32),
            })

    # -- SubmapDataset API -------------------------------------------------
    @property
    def num_kfs(self) -> int:
        return self._num_frames

    def get_odometry_at_pose(self, src_id: int) -> np.ndarray:
        T_src = np.eye(4)
        T_src[:3, :3] = self.R_init[src_id]
        T_src[:3, 3] = self.t_init[src_id]
        T_dst = np.eye(4)
        T_dst[:3, :3] = self.R_init[src_id + 1]
        T_dst[:3, 3] = self.t_init[src_id + 1]
        return (np.linalg.inv(T_src) @ T_dst).astype(np.float32)

    def sampled_points_at_kf(self, kf_id: int) -> np.ndarray:
        return self.scans_local[kf_id]

    def select_keyframes(self, kf_ids: Sequence[int]):
        self._selected = list(kf_ids)

    def unselect_keyframes(self):
        self._selected = None

    def true_kf_pose_in_world(self, kf_id: int):
        return self.R_gt[kf_id], self.t_gt[kf_id]

    def noisy_kf_pose_in_world(self, kf_id: int):
        return self.R_init[kf_id], self.t_init[kf_id]

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        kfs = self._selected if self._selected is not None else list(range(self.num_kfs))
        B = self.frame_batchsize
        out = {k: [] for k in ("coords_frame", "sdf", "weights", "sdf_valid",
                               "sdf_signs")}
        ids = []
        for kf in kfs:
            fr = self.frames[kf]
            sel = rng.choice(len(fr["points_frame"]), size=B)
            out["coords_frame"].append(fr["points_frame"][sel])
            out["sdf"].append(fr["sdf"][sel])
            out["weights"].append(fr["weights"][sel])
            out["sdf_valid"].append(fr["valid"][sel])
            out["sdf_signs"].append(fr["signs"][sel])
            ids.append(np.full((B,), kf, np.int32))
        batch = {k: np.concatenate(v) for k, v in out.items()}
        batch["sample_frame_ids"] = np.concatenate(ids)
        return batch
