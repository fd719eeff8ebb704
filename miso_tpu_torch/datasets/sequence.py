"""Synthetic SLAM sequence: a simulated sensor moving over a mesh (port of
``miso_tpu/datasets/sequence.py``).

Per keyframe a pinhole depth frame, or a spinning-LiDAR scan, is ray-cast
against the mesh on the host with the native BVH (``native.TriangleMesh.
raycast``), with numpy draws from the seed in the JAX package's order, so the
same mesh, trajectory and seed give the same frames, odometry and noisy poses.
Samples: surface hits (sdf 0, valid), near-surface perturbations along the
ray (sdf = -displacement), free-space samples (sign +1) and, optionally,
behind-surface samples (sign -1).  Odometry is the ground-truth relative pose
with optional injected noise.

:meth:`SdfSequence.device_pool` keeps every keyframe's rows resident on the
model's device, for the mapper's burst (``train/trainer.py::
make_train_burst_pool``) to draw its batches from.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.datasets.sdf_3d import MeshLike, as_mesh


def orbit_trajectory(center, radius, height, num_frames, look_at=None,
                     convention="opengl"):
    """Camera poses orbiting ``center`` looking inward.  Returns
    (N, 3, 3) rotations + (N, 3) positions.

    convention='opengl': camera looks along -z, y up (the SdfSequence /
    PosedSdf3D simulators).  'opencv': +z forward, y down (the RGB-D
    pinhole pipeline, utils/sample.ray_dirs_C)."""
    look_at = np.asarray(center, np.float64) if look_at is None else np.asarray(look_at)
    Rs, ts = [], []
    for i in range(num_frames):
        a = 2 * np.pi * i / num_frames
        pos = np.asarray(center, np.float64) + [radius * np.cos(a), radius * np.sin(a), height]
        fwd = look_at - pos
        fwd /= np.linalg.norm(fwd)
        upw = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, upw)
        right /= np.linalg.norm(right) + 1e-12
        up = np.cross(right, fwd)
        if convention == "opengl":
            # x right, y up, looks along -z.
            R = np.stack([right, up, -fwd], axis=1)
        else:
            # OpenCV: x right, y down, +z forward.
            R = np.stack([right, -up, fwd], axis=1)
        Rs.append(R)
        ts.append(pos)
    return np.asarray(Rs, np.float32), np.asarray(ts, np.float32)


def circuit_trajectory(half_extent, height, num_frames, laps=1.0,
                       corner_frac=0.35, seed=None, wobble=0.0):
    """Ground-robot tour of a square courtyard: a rounded-rectangle
    circuit of half-width ``half_extent``, sensor at ``height``, heading
    along the path (x forward, z up -- the LiDAR convention of
    :meth:`SdfSequence._lidar_rays`).  ``laps`` > 1 revisits the start
    (loop closure); ``wobble`` adds smooth lateral sway.

    Returns (N, 3, 3) rotations + (N, 3) positions.
    """
    a = half_extent * (1.0 - corner_frac)   # straight half-length
    r = half_extent * corner_frac           # corner radius
    straight, arc = 2 * a, (np.pi / 2) * r
    per = 4 * (straight + arc)
    s_all = (np.arange(num_frames) / num_frames) * laps * per

    def point(s):
        s = s % per
        segs = [straight, arc] * 4
        base = 0.0
        for i, L in enumerate(segs):
            if s <= base + L or i == 7:
                u = s - base
                side, kind = divmod(i, 2)
                ang0 = side * np.pi / 2
                c, sn = np.cos(ang0), np.sin(ang0)
                if kind == 0:  # straight along +y (rotated per side)
                    p = np.array([half_extent, -a + u])
                    d = np.array([0.0, 1.0])
                else:  # quarter arc around the corner
                    th = u / r
                    p = np.array([a + r * np.cos(th), a + r * np.sin(th)])
                    d = np.array([-np.sin(th), np.cos(th)])
                rot = np.array([[c, -sn], [sn, c]])
                return rot @ p, rot @ d
            base += L
        raise AssertionError

    rng = np.random.default_rng(0 if seed is None else seed)
    ph = rng.uniform(0, 2 * np.pi, 2)
    Rs, ts = [], []
    for k, s in enumerate(s_all):
        p2, d2 = point(s)
        if wobble:
            p2 = p2 + wobble * np.array([np.sin(0.13 * k + ph[0]),
                                         np.cos(0.17 * k + ph[1])])
        fwd = np.array([d2[0], d2[1], 0.0])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        left = np.cross(up, fwd)
        R = np.stack([fwd, left, up], axis=1)  # x fwd, y left, z up
        Rs.append(R)
        ts.append([p2[0], p2[1], height])
    return np.asarray(Rs, np.float32), np.asarray(ts, np.float32)


class SdfSequence(SubmapDataset):
    """Simulated posed depth sequence over a mesh."""

    def __init__(self, mesh: MeshLike, traj_R: np.ndarray, traj_t: np.ndarray,
                 frame_samples=2**12, frame_batchsize=1024,
                 near_surface_n=2, near_surface_std=0.05, free_space_n=1,
                 behind_surface_n=0, trunc_dist=0.15,
                 odom_std_rad=0.0, odom_std_meter=0.0,
                 pose_std_rad=0.0, pose_std_meter=0.0,
                 width=128, height=96, seed=0, surface_only=False,
                 scan_pattern="pinhole", max_range=None, voxel_size=None):
        self.mesh = as_mesh(mesh)
        self.R_gt = np.asarray(traj_R, np.float32)
        self.t_gt = np.asarray(traj_t, np.float32)
        self.trunc_dist = trunc_dist
        self.frame_samples = frame_samples
        self.frame_batchsize = frame_batchsize
        self.near_surface_n = 0 if surface_only else near_surface_n
        self.near_surface_std = near_surface_std
        self.free_space_n = 0 if surface_only else free_space_n
        self.behind_surface_n = 0 if surface_only else behind_surface_n
        self.width = width
        self.height = height
        self.scan_pattern = scan_pattern
        self.max_range = max_range
        self.voxel_size = voxel_size
        self._rng = np.random.default_rng(seed)
        self._selected: Optional[List[int]] = None
        self._simulate_frames()
        self._make_noisy_poses(pose_std_rad, pose_std_meter)
        self._make_odometry(odom_std_rad, odom_std_meter)

    # -- simulation --------------------------------------------------------
    def _pinhole_rays(self):
        W, H = self.width, self.height
        fx = W / 2.0
        i = (np.arange(W) + 0.5 - W / 2) / fx
        j = (np.arange(H) + 0.5 - H / 2) / fx
        ii, jj = np.meshgrid(i, j, indexing="xy")
        return np.stack([ii, -jj, -np.ones_like(ii)], axis=-1).reshape(-1, 3)

    def _lidar_rays(self):
        """Spinning-LiDAR scan: full 360 deg azimuth x a vertical fan
        (Ouster-style, the Newer College sensor behind the reference's
        PosedSdf3DLidar).  width = azimuth steps, height = elevation
        rings.  Omnidirectional frames are what make frame-to-model LM
        tracking well-conditioned: a narrow pinhole view rotating fast
        leaves the pose unconstrained along the unexplored leading edge."""
        W, H = self.width, self.height
        az = (np.arange(W) + 0.5) / W * 2 * np.pi
        el = np.radians(np.linspace(-45.0, 30.0, H))
        aa, ee = np.meshgrid(az, el, indexing="xy")
        ce = np.cos(ee)
        return np.stack([ce * np.cos(aa), ce * np.sin(aa), np.sin(ee)],
                        axis=-1).reshape(-1, 3)

    def _simulate_frames(self):
        dirs_cam = self._lidar_rays() if self.scan_pattern == "lidar" \
            else self._pinhole_rays()
        rng = self._rng
        self.frames = []
        for f in range(len(self.R_gt)):
            Rwc, twc = self.R_gt[f], self.t_gt[f]
            dirs = (dirs_cam @ Rwc.T).astype(np.float32)
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            origins = np.broadcast_to(twc, dirs.shape).astype(np.float32)
            t_hit, _ = self.mesh.raycast(origins, dirs)
            hit = t_hit > 0
            if self.max_range is not None:
                # Range crop (reference sdf_3d_lidar.py:126-133).
                hit = np.logical_and(hit, t_hit <= self.max_range)
            pts = origins[hit] + dirs[hit] * t_hit[hit][:, None]
            if self.voxel_size is not None and len(pts):
                # Voxel downsample (one point per cell): equalizes the
                # scan's spatial coverage -- raw ray samples pile up
                # ~1/d^2 on nearby ground and starve the distant walls
                # that constrain yaw/x/y in frame-to-model tracking
                # (reference voxel 0.6 m tracking / 0.08 m mapping,
                # full_slam_newer_college.py:77-92).
                key = np.floor(pts / self.voxel_size).astype(np.int64)
                _, idx = np.unique(key, axis=0, return_index=True)
                pts = pts[np.sort(idx)]
            n_hit = len(pts)
            assert n_hit > 0, f"frame {f}: no surface hits"
            keep = min(self.frame_samples, n_hit)
            sel = rng.permutation(n_hit)[:keep]
            pts = pts[sel]
            dist = np.maximum(np.linalg.norm(pts - twc, axis=1, keepdims=True), 1e-6)
            rdir = (pts - twc) / dist
            parts = [(pts, np.zeros((keep, 1), np.float32),
                      np.ones((keep, 1), np.float32), np.zeros((keep, 1), np.float32))]
            if self.near_surface_n:
                rd = np.repeat(dist, self.near_surface_n, 0)
                rr = np.repeat(rdir, self.near_surface_n, 0)
                disp = rng.standard_normal((keep * self.near_surface_n, 1)).astype(np.float32) \
                    * self.near_surface_std
                parts.append((twc + rr * (rd + disp), -disp,
                              np.ones_like(disp), np.zeros_like(disp)))
            if self.free_space_n:
                rd = np.repeat(dist, self.free_space_n, 0)
                rr = np.repeat(rdir, self.free_space_n, 0)
                ratio = 0.01 + rng.uniform(size=(keep * self.free_space_n, 1)) * 0.98
                disp = np.minimum((ratio - 1.0) * rd, -self.trunc_dist).astype(np.float32)
                parts.append((twc + rr * (rd + disp), -disp,
                              np.zeros_like(disp), np.ones_like(disp)))
            if self.behind_surface_n:
                rd = np.repeat(dist, self.behind_surface_n, 0)
                rr = np.repeat(rdir, self.behind_surface_n, 0)
                disp = (self.trunc_dist
                        + rng.uniform(size=(keep * self.behind_surface_n, 1))
                        * self.trunc_dist).astype(np.float32)
                parts.append((twc + rr * (rd + disp), -disp,
                              np.zeros_like(disp), -np.ones_like(disp)))
            pw = np.concatenate([p[0] for p in parts]).astype(np.float32)
            pf = (pw - twc) @ Rwc  # world -> frame
            self.frames.append({
                "points_frame": pf.astype(np.float32),
                "sdf": np.concatenate([p[1] for p in parts]).astype(np.float32),
                "valid": np.concatenate([p[2] for p in parts]).astype(np.float32),
                "signs": np.concatenate([p[3] for p in parts]).astype(np.float32),
            })

    def _make_noisy_poses(self, std_rad, std_meter):
        from scipy.spatial.transform import Rotation

        n = len(self.R_gt)
        rng = self._rng
        Rn = Rotation.from_rotvec(rng.standard_normal((n, 3)) * std_rad).as_matrix()
        Rn[0] = np.eye(3)
        tn = rng.standard_normal((n, 3)) * std_meter
        tn[0] = 0
        self.R_noisy = np.einsum("nij,njk->nik", self.R_gt, Rn).astype(np.float32)
        self.t_noisy = (self.t_gt + tn).astype(np.float32)

    def _make_odometry(self, std_rad, std_meter):
        """Per-step relative transforms with injected noise (the drift
        source for SLAM; reference datasets load ICP odometry)."""
        from scipy.spatial.transform import Rotation

        n = len(self.R_gt)
        rng = self._rng
        self.odometry = []
        for i in range(n - 1):
            T_ws = np.eye(4)
            T_ws[:3, :3] = self.R_gt[i]
            T_ws[:3, 3] = self.t_gt[i]
            T_wd = np.eye(4)
            T_wd[:3, :3] = self.R_gt[i + 1]
            T_wd[:3, 3] = self.t_gt[i + 1]
            T_sd = np.linalg.inv(T_ws) @ T_wd
            if std_rad > 0 or std_meter > 0:
                N = np.eye(4)
                N[:3, :3] = Rotation.from_rotvec(rng.standard_normal(3) * std_rad).as_matrix()
                N[:3, 3] = rng.standard_normal(3) * std_meter
                T_sd = T_sd @ N
            self.odometry.append(T_sd.astype(np.float32))

    # -- SubmapDataset API -------------------------------------------------
    @property
    def num_kfs(self) -> int:
        return len(self.R_gt)

    def get_odometry_at_pose(self, src_id: int) -> np.ndarray:
        return self.odometry[src_id]

    def sampled_points_at_kf(self, kf_id: int) -> np.ndarray:
        fr = self.frames[kf_id]
        surf = fr["points_frame"][: min(self.frame_samples, len(fr["points_frame"]))]
        return surf

    def select_keyframes(self, kf_ids: Sequence[int]):
        self._selected = list(kf_ids)

    def unselect_keyframes(self):
        self._selected = None

    def true_kf_pose_in_world(self, kf_id: int):
        return self.R_gt[kf_id], self.t_gt[kf_id]

    def noisy_kf_pose_in_world(self, kf_id: int):
        return self.R_noisy[kf_id], self.t_noisy[kf_id]

    def device_pool(self, device="cuda"):
        """The whole sequence's samples, resident on ``device``, and the
        current selection.

        Returns (pool: name -> (num_kfs, n_max, ...) float32 tensor, rows past
        a keyframe's count zero; sel (K,) int64 keyframe ids of the
        selection; n_rows (num_kfs,) int32 row counts; frame_batchsize).  The
        pool is allocated once at the full sequence size on the first call's
        device, and each keyframe's rows are copied there once, when a
        selection first holds it.
        """
        device = torch.device(device)
        kfs = self._selected if self._selected is not None \
            else list(range(self.num_kfs))
        names = (("coords_frame", "points_frame"), ("sdf", "sdf"),
                 ("sdf_valid", "valid"), ("sdf_signs", "signs"))
        if not hasattr(self, "_pool"):
            self._pool_nmax = max(f["points_frame"].shape[0] for f in self.frames)
            self._pool = {
                out: torch.zeros((self.num_kfs, self._pool_nmax)
                                 + self.frames[0][src].shape[1:],
                                 dtype=torch.float32, device=device)
                for out, src in names}
            self._pool_nrows = torch.zeros((self.num_kfs,), dtype=torch.int32,
                                           device=device)
            self._pool_loaded = set()
            self._pool_sel = None
        pool_dev = self._pool_nrows.device
        if pool_dev != device and not (device.index is None and pool_dev.type == device.type):
            raise ValueError(f"the pool lives on {pool_dev}, asked for on {device}")
        for kf in kfs:
            if kf not in self._pool_loaded:
                self._pool_loaded.add(kf)
                fr = self.frames[kf]
                n = fr["points_frame"].shape[0]
                for out, src in names:
                    self._pool[out][kf, :n] = torch.from_numpy(fr[src]).to(pool_dev)
                self._pool_nrows[kf] = n
        sel = tuple(kfs)
        if self._pool_sel != sel:
            self._pool_sel = sel
            self._pool_sel_dev = torch.as_tensor(sel, dtype=torch.int64, device=pool_dev)
        return self._pool, self._pool_sel_dev, self._pool_nrows, self.frame_batchsize

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """frame_batchsize samples per selected KF, fixed shape per
        selection size (sdf_3d_lidar.py:374-428 getitem_world analog)."""
        kfs = self._selected if self._selected is not None else list(range(self.num_kfs))
        B = self.frame_batchsize
        coords, sdf, valid, signs, ids = [], [], [], [], []
        for kf in kfs:
            fr = self.frames[kf]
            n = fr["points_frame"].shape[0]
            sel = rng.choice(n, size=B)
            coords.append(fr["points_frame"][sel])
            sdf.append(fr["sdf"][sel])
            valid.append(fr["valid"][sel])
            signs.append(fr["signs"][sel])
            ids.append(np.full((B,), kf, np.int32))
        N = B * len(kfs)
        return {
            "coords_frame": np.concatenate(coords),
            "sample_frame_ids": np.concatenate(ids),
            "weights": np.ones((N, 1), np.float32),
            "sdf": np.concatenate(sdf),
            "sdf_valid": np.concatenate(valid),
            "sdf_signs": np.concatenate(signs),
        }
