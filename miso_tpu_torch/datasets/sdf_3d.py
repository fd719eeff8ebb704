"""Synthetic mesh-based SDF datasets (port of ``miso_tpu/datasets/sdf_3d.py``:
``Sdf3D``, ``PosedSdf3D``, ``BatchedSdf3D``, ``BatchPosedSdf3D``).

The native BVH runtime (``miso_tpu_torch/native``) gives the signed distance
(positive outside) and casts the simulated cameras' rays.  Sampling is numpy
from a seed, so the same mesh and seed give the JAX package's batches
exactly.  ``PosedSdf3D``'s camera rotations and pose noise are drawn from
``torch.Generator``s seeded from the same numbers, whose streams differ from
the JAX package's keys: hand it the rotations (``rotations=``) to reproduce
the JAX package's frames.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from miso_tpu_torch.datasets.base import Dataset
from miso_tpu_torch.native import TriangleMesh

MeshLike = Union[str, TriangleMesh, Tuple[np.ndarray, np.ndarray]]


def as_mesh(mesh: MeshLike) -> TriangleMesh:
    if isinstance(mesh, TriangleMesh):
        return mesh
    if isinstance(mesh, str):
        from miso_tpu_torch.utils.sdf import read_ply
        return TriangleMesh(*read_ply(mesh))
    verts, tris = mesh
    return TriangleMesh(verts, tris)


class Sdf3D(Dataset):
    """GT-SDF dataset from a watertight mesh.

    Sampling: 7/8 surface points (the second half perturbed by
    ``surface_stddev``), 1/8 uniform in the (buffered) bound.  Exact surface
    samples get sdf label 0.
    """

    def __init__(self, mesh: MeshLike, batch_size=2**16, total_samples=2**20,
                 surface_stddev=0.1, bound_buffer=0.5, trunc_dist=None, seed=0):
        self.mesh = as_mesh(mesh)
        v = self.mesh.vertices
        self.bound = np.stack([v.min(0) - bound_buffer, v.max(0) + bound_buffer], axis=1)
        self.surface_stddev = surface_stddev
        self.total_samples = int(total_samples)
        self.batch_size = int(batch_size)
        self.trunc_dist = trunc_dist
        if self.total_samples % 8:
            raise ValueError(f"total_samples {self.total_samples} is not a multiple of 8")
        self._rng = np.random.default_rng(seed)
        self.resample()

    def resample(self):
        n = self.total_samples
        rng = self._rng
        pts_surf = self.mesh.sample_surface(n * 7 // 8, seed=int(rng.integers(2**31)))
        perturb_lo = n // 2
        pts_surf[perturb_lo:] += (self.surface_stddev * rng.standard_normal(
            (n * 7 // 8 - perturb_lo, 3))).astype(np.float32)
        u = rng.uniform(size=(n // 8, 3))
        pts_unif = (self.bound[:, 0] + u * (self.bound[:, 1] - self.bound[:, 0])
                    ).astype(np.float32)
        points = np.concatenate([pts_surf, pts_unif]).astype(np.float32)
        sdfs = np.zeros((n, 1), np.float32)
        sdfs[n // 2:] = self.mesh.signed_distance(points[n // 2:])[:, None]
        sdf_valid = (np.abs(sdfs) < 1e10).astype(np.float32)
        sdf_signs = np.zeros_like(sdfs)
        if self.trunc_dist is not None:
            sdf_valid = (np.abs(sdfs) < self.trunc_dist).astype(np.float32)
            sdf_signs[(sdfs > self.trunc_dist) & (np.abs(sdfs) < 1e10)] = 1
            sdf_signs[sdfs < -self.trunc_dist] = -1
        self.coords = points
        self.sdfs = sdfs
        self.sdf_valid = sdf_valid
        self.sdf_signs = sdf_signs

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.choice(self.total_samples, size=self.batch_size)
        return {
            "coords": self.coords[idx],
            "sdf": self.sdfs[idx],
            "sdf_valid": self.sdf_valid[idx],
            "sdf_sign": self.sdf_signs[idx],
            "sdf_signs": self.sdf_signs[idx],
        }


class PosedSdf3D(Dataset):
    """Simulated pinhole camera views of a mesh.

    Per frame: ray-cast a 90-degree-FOV pinhole image from a random
    free-space camera pose; keep up to ``frame_samples`` hits (surface,
    sdf=0, optionally distance-perturbed); add near-surface samples
    (label = -displacement along the ray) and free-space samples (sign +1,
    label = the distance to the hit).  ``rotations`` (num_frames, 3, 3) gives
    the camera orientations; when None they are drawn, Exp(w) with
    w ~ N(0, I), from a generator seeded with ``seed``.
    """

    def __init__(self, mesh: MeshLike, frame_batchsize=2**14, frame_samples=2**14,
                 num_frames=64, near_surface_n=2, near_surface_std=0.05,
                 free_space_n=1, trunc_dist=0.15, frame_std_rad=0.0,
                 frame_std_meter=0.0, distance_std=0.0, seed=0,
                 width=160, height=120, camera_min_clearance=0.3,
                 rotations: Optional[np.ndarray] = None):
        from miso_tpu_torch.ops import se3

        self.mesh = as_mesh(mesh)
        v = self.mesh.vertices
        self.bound = np.stack([v.min(0), v.max(0)], axis=1)
        self.near_surface_std = near_surface_std
        self.near_surface_n = near_surface_n
        self.free_space_n = free_space_n
        self.trunc_dist = trunc_dist
        self.frame_std_rad = frame_std_rad
        self.frame_std_meter = frame_std_meter
        self.distance_std = distance_std
        self.num_frames = num_frames
        self.frame_samples = frame_samples
        self.frame_batchsize = frame_batchsize
        self.width = width
        self.height = height
        self._rng = np.random.default_rng(seed)

        # Camera poses: orientations, then positions drawn until one lies in
        # free space.
        if rotations is None:
            rotations = se3.wrapped_gaussian_rotations(
                num_frames, 1.0, torch.Generator().manual_seed(seed)).numpy()
        rotations = np.array(rotations, np.float32)
        if rotations.shape != (num_frames, 3, 3):
            raise ValueError(f"rotations {rotations.shape}, expected ({num_frames}, 3, 3)")
        self.R_world_frame_gt = rotations
        t = np.zeros((num_frames, 3), np.float32)
        for f in range(num_frames):
            for _ in range(1000):
                u = self._rng.uniform(size=3)
                p = self.bound[:, 0] + u * (self.bound[:, 1] - self.bound[:, 0])
                if self.mesh.signed_distance(p[None].astype(np.float32))[0] > camera_min_clearance:
                    t[f] = p
                    break
            else:
                raise RuntimeError("Could not place camera in free space.")
        self.t_world_frame_gt = t
        self.sample_frames()
        self.resample_poses()

    # -- simulation --------------------------------------------------------
    def _pinhole_rays(self, Rwc, twc):
        """A 90-degree-FOV pinhole looking along camera -z."""
        W, H = self.width, self.height
        fx = W / 2.0
        i = (np.arange(W) + 0.5 - W / 2) / fx
        j = (np.arange(H) + 0.5 - H / 2) / fx
        ii, jj = np.meshgrid(i, j, indexing="xy")
        dirs_cam = np.stack([ii, -jj, -np.ones_like(ii)], axis=-1).reshape(-1, 3)
        dirs_world = dirs_cam @ Rwc.T
        dirs_world /= np.linalg.norm(dirs_world, axis=1, keepdims=True)
        origins = np.broadcast_to(twc, dirs_world.shape)
        return origins.astype(np.float32), dirs_world.astype(np.float32)

    def sample_frames(self):
        rng = self._rng
        self.frames: List[Dict[str, np.ndarray]] = []
        for f in range(self.num_frames):
            Rwc = self.R_world_frame_gt[f]
            twc = self.t_world_frame_gt[f]
            origins, dirs = self._pinhole_rays(Rwc, twc)
            t_hit, _ = self.mesh.raycast(origins, dirs)
            hit = t_hit > 0
            if not hit.any():
                # An open scene: aim at the mesh's centroid instead.
                center = self.mesh.vertices.mean(0)
                fwd = center - twc
                fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
                upw = np.array([0, 0, 1.0], np.float32)
                right = np.cross(fwd, upw)
                if np.linalg.norm(right) < 1e-6:
                    right = np.array([1.0, 0, 0], np.float32)
                right = right / np.linalg.norm(right)
                up = np.cross(right, fwd)
                Rwc = np.stack([right, up, -fwd], axis=1).astype(np.float32)
                self.R_world_frame_gt[f] = Rwc
                origins, dirs = self._pinhole_rays(Rwc, twc)
                t_hit, _ = self.mesh.raycast(origins, dirs)
                hit = t_hit > 0
            pts_hit_gt = origins[hit] + dirs[hit] * t_hit[hit][:, None]
            n_hit = len(pts_hit_gt)
            if n_hit == 0:
                raise RuntimeError(f"Frame {f} has no hit point")
            n_keep = min(self.frame_samples, n_hit)
            sel = rng.permutation(n_hit)[:n_keep]
            pts_hit_gt = pts_hit_gt[sel]

            parts_p, parts_sdf, parts_valid, parts_sign = [], [], [], []
            # Surface hits, with optional distance noise.
            dist_gt = np.maximum(np.linalg.norm(pts_hit_gt - twc, axis=1, keepdims=True), 1e-6)
            dirs_gt = (pts_hit_gt - twc) / dist_gt
            dist_pert = dist_gt + rng.standard_normal((n_keep, 1)) * self.distance_std
            pts_hit = (twc + dirs_gt * dist_pert).astype(np.float32)
            sdfs = self.mesh.signed_distance(pts_hit_gt)[:, None]
            parts_p.append(pts_hit)
            parts_sdf.append(sdfs)
            parts_valid.append(np.ones((n_keep, 1), np.float32))
            parts_sign.append(np.zeros((n_keep, 1), np.float32))
            # Near-surface perturbations along the ray.
            dist = np.maximum(np.linalg.norm(pts_hit - twc, axis=1, keepdims=True), 1e-6)
            dirs_n = (pts_hit - twc) / dist
            rep_dist = np.repeat(dist, self.near_surface_n, axis=0)
            rep_dir = np.repeat(dirs_n, self.near_surface_n, axis=0)
            disp = rng.standard_normal((n_keep * self.near_surface_n, 1)) * self.near_surface_std
            near_pts = (twc + rep_dir * (rep_dist + disp)).astype(np.float32)
            parts_p.append(near_pts)
            parts_sdf.append((-disp).astype(np.float32))
            parts_valid.append(np.ones_like(disp, dtype=np.float32))
            parts_sign.append(np.zeros_like(disp, dtype=np.float32))
            # Free-space samples at a random fraction of the way to the hit.
            rep_dist = np.repeat(dist, self.free_space_n, axis=0)
            rep_dir = np.repeat(dirs_n, self.free_space_n, axis=0)
            ratio = 0.01 + rng.uniform(size=(n_keep * self.free_space_n, 1)) * 0.98
            disp = np.minimum((ratio - 1.0) * rep_dist, -self.trunc_dist)
            free_pts = (twc + rep_dir * (rep_dist + disp)).astype(np.float32)
            parts_p.append(free_pts)
            parts_sdf.append((-disp).astype(np.float32))
            parts_valid.append(np.zeros_like(disp, dtype=np.float32))
            parts_sign.append(np.ones_like(disp, dtype=np.float32))

            pts_world = np.concatenate(parts_p)
            pts_frame = (pts_world - twc) @ Rwc  # R^T (x - t)
            self.frames.append({
                "points_frame": pts_frame.astype(np.float32),
                "sdfs": np.concatenate(parts_sdf).astype(np.float32),
                "sdfs_valid": np.concatenate(parts_valid),
                "signs": np.concatenate(parts_sign),
            })

    def resample_poses(self):
        """Noisy pose estimates: the true poses with N(0, frame_std_meter^2)
        translation and wrapped-Gaussian rotation noise, the first frame
        exact.  The noise comes from a generator seeded by the numpy
        stream."""
        from miso_tpu_torch.ops import se3

        gen = torch.Generator().manual_seed(int(self._rng.integers(2**31)))
        t_noise = se3.gaussian_translations(self.num_frames, self.frame_std_meter, gen).numpy()
        R_noise = se3.wrapped_gaussian_rotations(self.num_frames, self.frame_std_rad,
                                                 gen).numpy()
        t_noise[0] = 0.0
        R_noise[0] = np.eye(3)
        self.t_world_frame = (self.t_world_frame_gt + t_noise).astype(np.float32)
        self.R_world_frame = np.einsum("nij,njk->nik", self.R_world_frame_gt,
                                       R_noise).astype(np.float32)

    # -- pose accessors ----------------------------------------------------
    def true_kf_pose_in_world(self, kf_id):
        return self.R_world_frame_gt[kf_id], self.t_world_frame_gt[kf_id]

    def noisy_kf_pose_in_world(self, kf_id):
        return self.R_world_frame[kf_id], self.t_world_frame[kf_id]

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """``frame_batchsize`` samples per frame, drawn with replacement, and
        flat frame ids."""
        B = self.frame_batchsize
        coords, sdfs, valid, signs, ids = [], [], [], [], []
        for f, fr in enumerate(self.frames):
            n = fr["points_frame"].shape[0]
            sel = rng.choice(n, size=B)
            coords.append(fr["points_frame"][sel])
            sdfs.append(fr["sdfs"][sel])
            valid.append(fr["sdfs_valid"][sel])
            signs.append(fr["signs"][sel])
            ids.append(np.full((B,), f, np.int32))
        N = B * self.num_frames
        return {
            "coords_frame": np.concatenate(coords),
            "sample_frame_ids": np.concatenate(ids),
            "weights": np.ones((N, 1), np.float32),
            "sdf": np.concatenate(sdfs),
            "sdf_valid": np.concatenate(valid),
            "sdf_signs": np.concatenate(signs),
            "R_world_frame": self.R_world_frame,
            "t_world_frame": self.t_world_frame,
        }

    def get_inflated_bound(self, buffer=0.5):
        return np.stack([self.bound[:, 0] - buffer, self.bound[:, 1] + buffer], axis=1)


class BatchedSdf3D(Dataset):
    """Several :class:`Sdf3D` scenes; each sample is from a random one."""

    def __init__(self, meshes: Sequence[MeshLike], **kwargs):
        self.datasets = [Sdf3D(m, **kwargs) for m in meshes]

    def __len__(self):
        return len(self.datasets)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        i = int(rng.integers(len(self.datasets)))
        batch = self.datasets[i].sample(rng)
        batch["dataset_index"] = np.asarray(i, np.int32)
        return batch


class BatchPosedSdf3D(Dataset):
    """Several :class:`PosedSdf3D` scenes (scene i seeded with i); each sample
    is from a random one, whose pose noise is redrawn every
    ``resample_pose_every`` samples (never with 0)."""

    def __init__(self, meshes: Sequence[MeshLike], resample_pose_every=0, **kwargs):
        self.datasets = [PosedSdf3D(m, seed=i, **kwargs) for i, m in enumerate(meshes)]
        self.resample_pose_every = resample_pose_every
        self._count = 0

    def __len__(self):
        return len(self.datasets)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        i = int(rng.integers(len(self.datasets)))
        if self.resample_pose_every and self._count % self.resample_pose_every == 0:
            self.datasets[i].resample_poses()
        self._count += 1
        batch = self.datasets[i].sample(rng)
        batch["dataset_index"] = np.asarray(i, np.int32)
        return batch
