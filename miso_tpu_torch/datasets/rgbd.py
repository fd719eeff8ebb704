"""Posed RGB-D pipeline: iSDF-style ray sampling over depth keyframes (port of
``miso_tpu/datasets/rgbd.py``, host numpy as there).

Per keyframe: random valid-depth pixels, surface, near-surface and
stratified depth samples along each ray, the "ray" bound as the SDF label,
valid inside the truncation, signed +1 / -1 beyond it.  Subclasses provide
the depth frames, poses and intrinsics; :class:`SyntheticRgbd` ray-casts a
mesh with the native BVH (the fake sensor of tests and demos),
:class:`PosedSdfRgbd` reads a folder of 16-bit depth PNGs and pose files.
Optional per-frame CLIP feature maps add surface points with their
embeddings to each batch.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.utils import sample as S


class PosedRgbdBase(SubmapDataset):
    """Subclass contract: fill these in __init__.

    depth:   (N, H, W) float32 depth (z-convention), 0/NaN = invalid
    T_WC_gt: (N, 4, 4) GT camera-to-world
    T_WC:    (N, 4, 4) noisy/odometry camera-to-world (init estimates)
    fx, fy, cx, cy: intrinsics
    """

    def _setup(self, n_rays=200, depth_range=(0.07, 12.0),
               dist_behind_surf=0.1, n_strat_samples=19, n_surf_samples=8,
               trunc_dist=0.15, bounds_method="ray", normal_trunc_dist=0.1,
               seed=0):
        self.n_rays = n_rays
        self.min_depth, self.max_depth = depth_range
        self.dist_behind_surf = dist_behind_surf
        self.n_strat = n_strat_samples
        self.n_surf = n_surf_samples
        self.trunc_dist = trunc_dist
        self.bounds_method = bounds_method
        self.normal_trunc_dist = normal_trunc_dist
        self._selected: Optional[List[int]] = None
        self._rng = np.random.default_rng(seed)
        H, W = self.depth.shape[1:]
        self.dirs_C = S.ray_dirs_C(H, W, self.fx, self.fy, self.cx, self.cy)
        self.normals = None  # filled lazily for bounds_method == 'normal'
        # Optional CLIP supervision (sdf_rgbd.py:295-380): per-frame CLIP
        # feature maps (N, Hc, Wc, D); surface back-projections of
        # sampled pixels are emitted with their embeddings.
        self.clip_features: Optional[np.ndarray] = getattr(self, "clip_features", None)
        self.n_clip_rays = 64

    # -- SubmapDataset API -------------------------------------------------
    @property
    def num_kfs(self) -> int:
        return len(self.depth)

    def get_odometry_at_pose(self, src_id: int) -> np.ndarray:
        return (np.linalg.inv(self.T_WC[src_id]) @ self.T_WC[src_id + 1]
                ).astype(np.float32)

    def sampled_points_at_kf(self, kf_id: int) -> np.ndarray:
        d = self.depth[kf_id]
        pc = S.pointcloud_from_depth(d, self.fx, self.fy, self.cx, self.cy)
        pts = pc.reshape(-1, 3)
        pts = pts[np.isfinite(pts).all(axis=1)]
        if len(pts) > 4096:
            pts = pts[self._rng.choice(len(pts), 4096, replace=False)]
        return pts.astype(np.float32)

    def select_keyframes(self, kf_ids: Sequence[int]):
        self._selected = list(kf_ids)

    def unselect_keyframes(self):
        self._selected = None

    def true_kf_pose_in_world(self, kf_id: int):
        T = self.T_WC_gt[kf_id]
        return T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)

    def noisy_kf_pose_in_world(self, kf_id: int):
        T = self.T_WC[kf_id]
        return T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)

    # -- CLIP supervision ----------------------------------------------------
    def load_clip_features(self, path: str, key: str = "clip_features",
                           n_clip_rays: Optional[int] = None):
        """Load per-frame CLIP feature maps into ``clip_features``.

        Mirrors the reference's per-frame CLIP grids
        (sdf_rgbd.py:295-380).  Accepted formats:
          * one ``.npz`` with an (N, Hc, Wc, D) array under ``key`` (or
            its single array),
          * one ``.pt`` torch file (tensor or dict with ``key``),
          * a directory of per-frame ``.npy``/``.npz``/``.pt`` files
            (sorted), each (Hc, Wc, D).
        """
        def _one(p):
            if p.endswith(".npy"):
                return np.load(p)
            if p.endswith(".npz"):
                z = np.load(p)
                return z[key] if key in z else z[z.files[0]]
            if p.endswith(".pt"):
                obj = torch.load(p, map_location="cpu")
                if isinstance(obj, dict):
                    obj = obj[key]
                return obj.numpy()
            raise ValueError(f"Unsupported CLIP feature file: {p}")

        if os.path.isdir(path):
            def natural(name):
                # Numeric-aware order: frame_2 before frame_10 even
                # without zero padding.
                return [int(t) if t.isdigit() else t
                        for t in re.split(r"(\d+)", name)]

            files = sorted((f for f in os.listdir(path)
                            if f.endswith((".npy", ".npz", ".pt"))),
                           key=natural)
            feats = np.stack([_one(os.path.join(path, f)) for f in files])
        else:
            feats = _one(path)
        feats = np.asarray(feats, np.float32)
        assert feats.ndim == 4, f"want (N, Hc, Wc, D), got {feats.shape}"
        assert feats.shape[0] == self.num_kfs, (feats.shape, self.num_kfs)
        self.clip_features = feats
        if n_clip_rays is not None:
            self.n_clip_rays = int(n_clip_rays)
        return feats

    @property
    def clip_dim(self) -> Optional[int]:
        return None if self.clip_features is None else \
            int(self.clip_features.shape[-1])

    # -- sampling ----------------------------------------------------------
    def _sample_frame(self, rng, kf: int):
        """Fixed-size per-frame ray batch (scannet.py:386-469 recipe)."""
        H, W = self.depth.shape[1:]
        d = self.depth[kf]
        # Rejection-free valid pixel draw: sample from precomputed valid set.
        valid = np.flatnonzero((d.reshape(-1) > self.min_depth)
                               & np.isfinite(d.reshape(-1)))
        if len(valid) == 0:
            valid = np.array([0])
        pix = valid[rng.integers(0, len(valid), self.n_rays)]
        ih, iw = pix // W, pix % W
        depth_sample = d[ih, iw].astype(np.float32)
        dirs_C = self.dirs_C[ih, iw]
        # Sample depths: surface + near-surface + stratified up to
        # depth + dist_behind_surf (scannet.py / iSDF recipe).
        max_d = depth_sample + self.dist_behind_surf
        T = np.broadcast_to(np.eye(4, dtype=np.float32),
                            (self.n_rays, 4, 4))  # sample in CAMERA frame
        pc_cam, z_vals = S.sample_along_rays(
            rng, T, self.min_depth, max_d, self.n_strat, self.n_surf,
            dirs_C, gt_depth=depth_sample)
        bounds = S.bounds_ray(depth_sample, z_vals, dirs_C)
        coords = pc_cam.reshape(-1, 3)
        b = bounds.reshape(-1, 1)
        sdf_valid = (np.abs(b) < self.trunc_dist).astype(np.float32)
        signs = np.zeros_like(b)
        signs[b > self.trunc_dist] = 1.0
        signs[b < -self.trunc_dist] = -1.0
        return coords.astype(np.float32), b.astype(np.float32), sdf_valid, signs

    def _sample_clip(self, rng, kf: int):
        """Surface points + CLIP embeddings for one frame
        (sdf_rgbd.py:295-380 getitem_clip: depth-interp into the CLIP
        grid)."""
        H, W = self.depth.shape[1:]
        Hc, Wc = self.clip_features.shape[1:3]
        d = self.depth[kf]
        valid = np.flatnonzero((d.reshape(-1) > self.min_depth)
                               & np.isfinite(d.reshape(-1)))
        if len(valid) == 0:
            valid = np.array([0])
        pix = valid[rng.integers(0, len(valid), self.n_clip_rays)]
        ih, iw = pix // W, pix % W
        depth_sample = d[ih, iw].astype(np.float32)
        pts_cam = self.dirs_C[ih, iw] * depth_sample[:, None]
        emb = self.clip_features[kf, (ih * Hc) // H, (iw * Wc) // W]
        return pts_cam.astype(np.float32), emb.astype(np.float32)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        kfs = self._selected if self._selected is not None else list(range(self.num_kfs))
        coords, sdf, valid, signs, ids = [], [], [], [], []
        clip_pts, clip_emb, clip_ids = [], [], []
        per = self.n_rays * (self.n_strat + self.n_surf)
        for kf in kfs:
            c, b, v, s = self._sample_frame(rng, kf)
            coords.append(c)
            sdf.append(b)
            valid.append(v)
            signs.append(s)
            ids.append(np.full((per,), kf, np.int32))
            if self.clip_features is not None:
                cp, ce = self._sample_clip(rng, kf)
                clip_pts.append(cp)
                clip_emb.append(ce)
                clip_ids.append(np.full((len(cp),), kf, np.int32))
        N = per * len(kfs)
        batch = {
            "coords_frame": np.concatenate(coords),
            "sample_frame_ids": np.concatenate(ids),
            "weights": np.ones((N, 1), np.float32),
            "sdf": np.concatenate(sdf),
            "sdf_valid": np.concatenate(valid),
            "sdf_signs": np.concatenate(signs),
        }
        if clip_pts:
            batch["clip_coords_frame"] = np.concatenate(clip_pts)
            batch["clip_sample_frame_ids"] = np.concatenate(clip_ids)
            batch["clip_embeddings"] = np.concatenate(clip_emb)
        return batch


class SyntheticRgbd(PosedRgbdBase):
    """Depth frames ray-cast from a mesh with the native BVH -- the fake
    RGB-D sensor for tests and demos."""

    def __init__(self, mesh, traj_R, traj_t, width=128, height=96,
                 fov_deg=90.0, pose_std_rad=0.0, pose_std_meter=0.0,
                 depth_noise_std=0.0, seed=0, **sample_kwargs):
        from miso_tpu_torch.datasets.sdf_3d import as_mesh
        from scipy.spatial.transform import Rotation

        mesh = as_mesh(mesh)
        rng = np.random.default_rng(seed)
        n = len(traj_R)
        W, H = width, height
        fx = W / (2 * np.tan(np.radians(fov_deg) / 2))
        self.fx = self.fy = fx
        self.cx, self.cy = (W - 1) / 2.0, (H - 1) / 2.0
        dirs = S.ray_dirs_C(H, W, self.fx, self.fy, self.cx, self.cy)
        depths = []
        T_gt = []
        for i in range(n):
            # OpenCV camera (+z forward): world dirs = R @ [x, y, z].
            Rwc = np.asarray(traj_R[i], np.float32)
            twc = np.asarray(traj_t[i], np.float32).reshape(3)
            dw = dirs.reshape(-1, 3) @ Rwc.T
            dn = dw / np.linalg.norm(dw, axis=1, keepdims=True)
            o = np.broadcast_to(twc, dn.shape).astype(np.float32)
            t_hit, _ = mesh.raycast(o, dn.astype(np.float32))
            # t_hit is along the unit dir; z-depth = t * (camera-z comp).
            z = np.where(t_hit > 0, t_hit * (dn @ Rwc)[:, 2], 0.0)
            if depth_noise_std > 0:
                z = z + rng.normal(0, depth_noise_std, z.shape) * (z > 0)
            depths.append(z.reshape(H, W).astype(np.float32))
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = Rwc
            T[:3, 3] = twc
            T_gt.append(T)
        self.depth = np.stack(depths)
        self.T_WC_gt = np.stack(T_gt)
        Rn = Rotation.from_rotvec(rng.standard_normal((n, 3)) * pose_std_rad).as_matrix()
        Rn[0] = np.eye(3)
        tn = rng.standard_normal((n, 3)) * pose_std_meter
        tn[0] = 0
        self.T_WC = self.T_WC_gt.copy()
        self.T_WC[:, :3, :3] = np.einsum("nij,njk->nik",
                                         self.T_WC_gt[:, :3, :3], Rn)
        self.T_WC[:, :3, 3] += tn
        self._setup(seed=seed, **sample_kwargs)


class PosedSdfRgbd(PosedRgbdBase):
    """Raw RGB-D folder loader (reference `grid_opt/datasets/sdf_rgbd.py`):
    per-frame pose txt files + 16-bit depth PNGs (sdf_rgbd.py:150-215),
    normals estimated from depth on demand (sdf_rgbd.py:203-207).

    Expects ``<root>/depth/*.png`` and ``<root>/pose/*.txt`` (4x4 rows),
    with intrinsics either passed explicitly or from a ScanNet-style
    info file.
    """

    def __init__(self, root: str, depth_scale=1000.0, intrinsics=None,
                 intrinsics_file=None, frame_stride=1, max_frames=None,
                 clip_features_path=None, **sample_kwargs):
        depth_files = sorted(glob.glob(os.path.join(root, "depth", "*.png")))
        pose_files = sorted(glob.glob(os.path.join(root, "pose", "*.txt")))
        n = min(len(depth_files), len(pose_files))
        idxs = list(range(0, n, frame_stride))
        if max_frames:
            idxs = idxs[:max_frames]
        assert idxs, f"no frames found under {root}"
        try:
            import cv2
            read_png = lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED)
        except Exception:  # PIL fallback
            from PIL import Image
            read_png = lambda p: np.array(Image.open(p))
        depths, poses = [], []
        for i in idxs:
            d = read_png(depth_files[i]).astype(np.float32) / depth_scale
            depths.append(d)
            poses.append(np.loadtxt(pose_files[i]).reshape(4, 4).astype(np.float32))
        self.depth = np.stack(depths)
        self.T_WC_gt = np.stack(poses)
        self.T_WC = self.T_WC_gt.copy()
        if intrinsics is not None:
            self.fx, self.fy, self.cx, self.cy = intrinsics
        elif intrinsics_file is not None:
            from miso_tpu_torch.datasets.scannet import load_scannet_intrinsics
            self.fx, self.fy, self.cx, self.cy, _, _ = \
                load_scannet_intrinsics(intrinsics_file)
        else:
            H, W = self.depth.shape[1:]
            self.fx = self.fy = 0.9 * W
            self.cx, self.cy = (W - 1) / 2.0, (H - 1) / 2.0
        self._setup(**sample_kwargs)
        if clip_features_path:
            self.load_clip_features(clip_features_path)

    def estimate_normals(self, kf_id: int) -> np.ndarray:
        pc = S.pointcloud_from_depth(self.depth[kf_id], self.fx, self.fy,
                                     self.cx, self.cy)
        return S.estimate_pointcloud_normals(pc)
