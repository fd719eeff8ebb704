"""Reconstruction metrics (port of ``miso_tpu/utils/eval.py``: Chamfer /
MAE accuracy and completeness / precision / recall / F-score, with scipy's
cKDTree).  Umeyama alignment, ``trajectory_error`` and ICP wait for the SLAM
slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def nearest_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each src point, the distance to its nearest dst point."""
    tree = cKDTree(np.asarray(dst))
    d, _ = tree.query(np.asarray(src), k=1, workers=-1)
    return d


def compute_chamfer_metrics(points_pred: np.ndarray, points_gt: np.ndarray,
                            threshold: float = 0.05,
                            truncation_acc: float = 0.50,
                            truncation_com: float = 0.50) -> Dict[str, float]:
    """Chamfer / F-score metrics.

    Distances above the truncation are dropped from the MAE / Chamfer means,
    and precision / recall use ``threshold``.
    """
    d_p2g = nearest_distances(points_pred, points_gt)  # accuracy direction
    d_g2p = nearest_distances(points_gt, points_pred)  # completeness direction
    acc_kept = d_p2g[d_p2g < truncation_acc]
    com_kept = d_g2p[d_g2p < truncation_com]
    acc = float(acc_kept.mean()) if len(acc_kept) else float("inf")
    com = float(com_kept.mean()) if len(com_kept) else float("inf")
    chamfer_l1 = 0.5 * (acc + com)
    chamfer_l2 = (float(np.sqrt(0.5 * ((acc_kept ** 2).mean() + (com_kept ** 2).mean())))
                  if len(acc_kept) and len(com_kept) else float("inf"))
    precision = float((d_p2g < threshold).mean() * 100.0)
    recall = float((d_g2p < threshold).mean() * 100.0)
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {
        "MAE_accuracy (cm)": 100 * acc,
        "MAE_completeness (cm)": 100 * com,
        "Chamfer_L1 (cm)": 100 * chamfer_l1,
        "Chamfer_L2 (cm)": 100 * chamfer_l2,
        "Precision (%)": precision,
        "Recall (%)": recall,
        "F-score (%)": fscore,
    }


def sample_mesh_points(mesh, n: int, seed: int = 0) -> np.ndarray:
    """Uniform surface samples from a native TriangleMesh."""
    return mesh.sample_surface(n, seed=seed)


def mesh_reconstruction_metrics(mesh_pred, mesh_gt, n_points: int = 200000,
                                threshold: float = 0.05, truncation: float = 0.5,
                                seed: int = 0) -> Dict[str, float]:
    """Sample both meshes and compute the Chamfer metrics."""
    p_pred = sample_mesh_points(mesh_pred, n_points, seed)
    p_gt = sample_mesh_points(mesh_gt, n_points, seed + 1)
    return compute_chamfer_metrics(p_pred, p_gt, threshold, truncation, truncation)
