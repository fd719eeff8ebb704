"""Reconstruction and trajectory metrics (port of ``miso_tpu/utils/eval.py``):
Chamfer / MAE accuracy and completeness / precision / recall / F-score with
scipy's cKDTree, and the absolute trajectory error after a Umeyama
alignment, and point-to-point and point-to-plane ICP (host float64 with
cKDTree correspondences).
"""
from __future__ import annotations

from typing import Dict, Optional

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


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (or Sim(3)) alignment src -> dst (Umeyama 1991),
    in float64.  Returns (R, t, s)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((sc ** 2).sum() / len(src))) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def trajectory_error(traj_est: np.ndarray, traj_gt: np.ndarray,
                     align: bool = True) -> Dict[str, float]:
    """Absolute trajectory error, after an SE(3) alignment of the positions
    when ``align`` (and at least 3 poses).

    traj_*: (N, 4, 4) poses or (N, 3) positions.  Returns the RMSE, mean,
    median and std of the position errors in the input's units and, for
    poses, ``rot_rmse_deg`` of the rotations after the same alignment.
    """
    import torch

    from miso_tpu_torch.ops import se3

    est = np.asarray(traj_est)
    gt = np.asarray(traj_gt)
    p_est = est[:, :3, 3] if est.ndim == 3 else est
    p_gt = gt[:, :3, 3] if gt.ndim == 3 else gt
    R_align = np.eye(3)
    if align and len(p_est) >= 3:
        R_align, t, _ = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R_align.T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    out = {
        "ate_rmse": float(np.sqrt((err ** 2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_std": float(err.std()),
    }
    if est.ndim == 3 and gt.ndim == 3:
        R_est = torch.as_tensor((R_align[None] @ est[:, :3, :3]).astype(np.float32))
        out["rot_rmse_deg"] = float(se3.rotation_rmse_deg(
            R_est, torch.as_tensor(gt[:, :3, :3], dtype=torch.float32)))
    return out


def icp_point_to_point(src: np.ndarray, dst: np.ndarray, init_T: Optional[np.ndarray] = None,
                       max_iters: int = 50, max_corr_dist: float = 0.5, tol: float = 1e-6,
                       robust_k: Optional[float] = None):
    """Point-to-point ICP in float64: nearest-neighbour correspondences under
    ``max_corr_dist`` (and ``robust_k``, a hard robust cut), a Umeyama step
    each iteration, until the mean squared distance changes by less than
    ``tol``.  Returns (T (4, 4), rmse, fitness)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    T = np.eye(4) if init_T is None else np.asarray(init_T, np.float64).copy()
    tree = cKDTree(dst)
    prev_err = np.inf
    rmse, fitness = np.inf, 0.0
    for _ in range(max_iters):
        cur = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(cur, k=1, workers=-1)
        mask = d < max_corr_dist
        if robust_k is not None:
            mask &= d < robust_k
        if mask.sum() < 3:
            break
        R, t, _ = umeyama_alignment(cur[mask], dst[idx[mask]])
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        err = float((d[mask] ** 2).mean())
        rmse = float(np.sqrt(err))
        fitness = float(mask.mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T, rmse, fitness


def icp_point_to_plane(src: np.ndarray, dst: np.ndarray, dst_normals: np.ndarray,
                       init_T: Optional[np.ndarray] = None, max_iters: int = 50,
                       max_corr_dist: float = 0.5, tol: float = 1e-8):
    """Point-to-plane ICP: each iteration minimises sum(((R p + t - q) . n_q)^2)
    linearised in a small rotation (a 6x6 Gauss-Newton solve in float64).  The
    step's rotation is ``se3.so3_exp`` in float32, as the JAX package builds
    it.  Returns (T (4, 4), rmse, fitness)."""
    import torch

    from miso_tpu_torch.ops import se3

    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n_all = np.asarray(dst_normals, np.float64)
    T = np.eye(4) if init_T is None else np.asarray(init_T, np.float64).copy()
    tree = cKDTree(dst)
    prev_err = np.inf
    rmse, fitness = np.inf, 0.0
    for _ in range(max_iters):
        cur = src @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(cur, k=1, workers=-1)
        mask = d < max_corr_dist
        if mask.sum() < 6:
            break
        P = cur[mask]
        Q = dst[idx[mask]]
        N = n_all[idx[mask]]
        r = np.einsum("ij,ij->i", P - Q, N)
        J = np.concatenate([np.cross(P, N), N], axis=1)   # d r / d(omega, t)
        x = np.linalg.solve(J.T @ J + 1e-9 * np.eye(6), -J.T @ r)
        dT = np.eye(4)
        dT[:3, :3] = se3.so3_exp(torch.as_tensor(x[:3], dtype=torch.float32)).numpy()
        dT[:3, 3] = x[3:]
        T = dT @ T
        err = float((r ** 2).mean())
        rmse = float(np.sqrt((d[mask] ** 2).mean()))
        fitness = float(mask.mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T, rmse, fitness
