"""Newer College dataset factory and mesh evaluation (port of
``miso_tpu/utils/ncd.py``): the LiDAR dataset with the evaluation sampling
profile, and a mesh held to the ground-truth survey cloud after a robust
two-stage point-to-point ICP.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def create_ncd_dataset(cfg: Dict, voxel_size=0.03, near_surf_std=0.1,
                       n_near=4, n_free=2, n_behind=1, frame_samples=2**12,
                       frame_batchsize=2**10, num_frames=None):
    """The Newer College evaluation profile of ``PosedSdf3DLidar``."""
    from miso_tpu_torch.datasets.lidar import PosedSdf3DLidar

    d = cfg["dataset"]
    return PosedSdf3DLidar(
        lidar_folder=d["path"], pose_file_gt=d["pose_gt"],
        pose_file_init=d["pose_init"], trunc_dist=d.get("trunc_dist", 0.5),
        num_frames=num_frames, frame_samples=frame_samples,
        frame_batchsize=frame_batchsize, voxel_size=voxel_size,
        near_surface_std=near_surf_std, near_surface_n=n_near,
        free_space_n=n_free, behind_surface_n=n_behind, min_dist_ratio=0.5,
        min_z=-10.0, max_z=60.0, min_range=1.5, max_range=60.0,
        adaptive_range=False)


def evaluate_ncd_mesh(est_mesh, ref_points: np.ndarray, n_points=500000,
                      threshold=0.20, truncation=0.5, robust_k=1.0, seed=0):
    """Chamfer metrics of a mesh against the GT survey cloud ref_points
    (N, 3), after a coarse and a fine point-to-point ICP with hard robust
    cuts."""
    from miso_tpu_torch.utils.eval import compute_chamfer_metrics, icp_point_to_point

    src = est_mesh.sample_surface(n_points, seed=seed)
    T1, _, _ = icp_point_to_point(src, ref_points, max_corr_dist=3.0,
                                  robust_k=robust_k * 15)
    src = src @ T1[:3, :3].T + T1[:3, 3]
    T2, _, _ = icp_point_to_point(src, ref_points, max_corr_dist=0.5,
                                  robust_k=robust_k)
    src = src @ T2[:3, :3].T + T2[:3, 3]
    sel = np.random.default_rng(seed).choice(
        len(ref_points), min(n_points, len(ref_points)), replace=False)
    return compute_chamfer_metrics(src, ref_points[sel], threshold,
                                   truncation, truncation)
