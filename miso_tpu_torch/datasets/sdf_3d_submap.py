"""Synthetic multi-submap dataset (port of
``miso_tpu/datasets/sdf_3d_submap.py``).

A mesh's AABB is partitioned into nx x ny overlapping submaps; cameras
orbit each submap's centre (one :class:`SdfSequence` over all keyframes,
every keyframe in one submap), and each submap's pose carries optional
noise: the synthetic problem that alignment is validated on.  Host numpy
from the seed, in the JAX package's order, so the same mesh and seed give
its frames, poses and batches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from miso_tpu_torch.datasets.base import SubmapDataset
from miso_tpu_torch.datasets.sdf_3d import MeshLike, as_mesh
from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory


class SubmapSdf3D(SubmapDataset):
    """Mesh AABB partitioned into overlapping submaps.

    Cameras orbit each submap's center; every keyframe belongs to one
    submap; GT and noisy submap poses are exposed for alignment
    experiments.
    """

    def __init__(self, mesh: MeshLike, nx=2, ny=1, frames_per_submap=6,
                 overlap=0.3, cam_height=1.0, frame_samples=2**11,
                 frame_batchsize=1024, trunc_dist=0.15,
                 submap_std_rad=0.0, submap_std_meter=0.0, seed=0, **seq_kwargs):
        self.mesh = as_mesh(mesh)
        v = self.mesh.vertices
        lo, hi = v.min(0), v.max(0)
        self.nx, self.ny = nx, ny
        self.frames_per_submap = frames_per_submap
        self.num_submaps = nx * ny
        rng = np.random.default_rng(seed)

        # Submap centers on the partition grid; bounds overlap by `overlap`.
        sx = (hi[0] - lo[0]) / nx
        sy = (hi[1] - lo[1]) / ny
        self.submap_centers = []
        self.submap_bounds_local = []
        Rs, ts = [], []
        radius = 0.4 * min(sx, sy)
        for ix in range(nx):
            for iy in range(ny):
                c = np.array([lo[0] + (ix + 0.5) * sx, lo[1] + (iy + 0.5) * sy,
                              (lo[2] + hi[2]) / 2], np.float32)
                self.submap_centers.append(c)
                half = np.array([sx / 2 + overlap, sy / 2 + overlap,
                                 (hi[2] - lo[2]) / 2 + overlap], np.float32)
                self.submap_bounds_local.append(
                    np.stack([-half, half], axis=1).astype(np.float32))
                R, t = orbit_trajectory(c, radius, cam_height, frames_per_submap,
                                        look_at=c)
                Rs.append(R)
                ts.append(t)
        traj_R = np.concatenate(Rs)
        traj_t = np.concatenate(ts)
        self._seq = SdfSequence(self.mesh, traj_R, traj_t,
                                frame_samples=frame_samples,
                                frame_batchsize=frame_batchsize,
                                trunc_dist=trunc_dist, seed=seed, **seq_kwargs)
        self.kf_to_submap = np.repeat(np.arange(self.num_submaps),
                                      frames_per_submap)
        # GT submap poses: identity orientation at the submap center.
        self.R_world_submap_gt = np.broadcast_to(
            np.eye(3, dtype=np.float32), (self.num_submaps, 3, 3)).copy()
        self.t_world_submap_gt = np.stack(self.submap_centers)
        # Noisy submap poses, submap 0 anchored.
        from scipy.spatial.transform import Rotation
        Rn = Rotation.from_rotvec(
            rng.standard_normal((self.num_submaps, 3)) * submap_std_rad).as_matrix()
        tn = rng.standard_normal((self.num_submaps, 3)) * submap_std_meter
        Rn[0] = np.eye(3)
        tn[0] = 0
        self.R_world_submap = np.einsum("nij,njk->nik",
                                        self.R_world_submap_gt, Rn).astype(np.float32)
        self.t_world_submap = (self.t_world_submap_gt + tn).astype(np.float32)

    # Submap accessors.
    def true_submap_pose(self, s: int):
        return self.R_world_submap_gt[s], self.t_world_submap_gt[s]

    def noisy_submap_pose(self, s: int):
        return self.R_world_submap[s], self.t_world_submap[s]

    def submap_bound(self, s: int) -> np.ndarray:
        return self.submap_bounds_local[s]

    def submap_id_for_kf(self, kf_id: int) -> int:
        return int(self.kf_to_submap[kf_id])

    # Delegate the SubmapDataset surface to the sequence.
    @property
    def num_kfs(self):
        return self._seq.num_kfs

    def get_odometry_at_pose(self, src_id):
        return self._seq.get_odometry_at_pose(src_id)

    def sampled_points_at_kf(self, kf_id):
        return self._seq.sampled_points_at_kf(kf_id)

    def select_keyframes(self, kf_ids):
        self._seq.select_keyframes(kf_ids)

    def unselect_keyframes(self):
        self._seq.unselect_keyframes()

    def true_kf_pose_in_world(self, kf_id):
        return self._seq.true_kf_pose_in_world(kf_id)

    def noisy_kf_pose_in_world(self, kf_id):
        return self._seq.noisy_kf_pose_in_world(kf_id)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        batch = self._seq.sample(rng)
        batch["sample_submap_ids"] = self.kf_to_submap[
            batch["sample_frame_ids"]].astype(np.int32)
        return batch
