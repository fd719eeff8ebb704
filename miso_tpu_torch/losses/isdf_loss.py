"""The iSDF paper's loss (port of ``miso_tpu/losses/isdf_loss.py``).

SDF supervision takes "ray bounds" as targets: samples beyond the truncation
distance get the free-space loss max(relu(pred - bound), exp(-beta * pred)
- 1); samples inside the band a direct residual weighted by
``trunc_weight``.  The eikonal term is masked to bounds >= eik_apply_dist.
Boolean selections are multiplicative masks; the submap variant's
per-submap terms are segment sums (``index_add``) over each point's submap.
``key`` is a ``torch.Generator`` (the smoothness noise).
"""
from __future__ import annotations

import torch

from miso_tpu_torch.losses import common
from miso_tpu_torch.ops import se3
from miso_tpu_torch.ops.diff import gradient3d


def isdf_sdf_loss_mat(pred, bounds, trunc_dist, loss_type="L1", free_space_factor=5.0):
    """Per-sample iSDF SDF loss and the free-space mask (bounds > trunc)."""
    free = bounds > trunc_dist
    fs_mat = torch.maximum(torch.relu(pred - bounds),
                           torch.exp(-free_space_factor * pred) - 1.0)
    mat = torch.where(free, fs_mat, pred - bounds)
    if loss_type == "L1":
        mat = torch.abs(mat)
    elif loss_type == "L2":
        mat = mat ** 2
    else:
        raise ValueError("loss_type must be L1 or L2")
    return mat, free


def _eikonal(model, pc, bounds, eik_apply_dist, g=None):
    if g is None:
        g = gradient3d(pc, model, method="autograd")
    eik = torch.abs(torch.linalg.vector_norm(g, dim=-1, keepdim=True) - 1.0)
    return torch.where(bounds < eik_apply_dist, torch.zeros_like(eik), eik)


def isdf_loss(model, batch, key=None, trunc_dist=0.15, sdf_weight=1.0,
              grad_weight=0.0, eik_weight=0.0, eik_apply_dist=0.1,
              free_space_factor=5.0, loss_type="L1", trunc_weight=1.0,
              smooth_weight=0.0, smooth_std=0.05, pose_reg_weight=0.0,
              pose_thresh_rad=1.0, pose_thresh_m=1.0, pose_lock_rows=None):
    """The SLAM form: keyframe-frame points moved to the world by the updated
    poses, the iSDF SDF loss with ``trunc_weight`` on the band, an optional
    eikonal, smoothness, and a trust region on the pose corrections."""
    ids = batch["sample_frame_ids"].reshape(-1).long() - model.anchor_kf.long()
    R, t = model.updated_kf_poses(lock_mask=pose_lock_rows)
    pc = se3.transform_points_by_id(batch["coords_frame"], ids, R, t)
    bounds = batch["sdf"]
    pred = model(pc)
    mat, free = isdf_sdf_loss_mat(pred, bounds, trunc_dist, loss_type, free_space_factor)
    total = torch.where(free, mat, mat * trunc_weight)
    if eik_weight > 0:
        total = total + eik_weight * _eikonal(model, pc, bounds, eik_apply_dist)
    out = {"sdf": torch.mean(total) * sdf_weight}
    if smooth_weight > 0:
        out["smooth"] = smooth_weight * common.smoothness_loss(
            model, pc, torch.ones_like(bounds), key, smooth_std)
    if pose_reg_weight > 0:
        out.update(common.pose_trust_region_loss(model.rot_corr, model.trans_corr,
                                                 pose_thresh_rad, pose_thresh_m,
                                                 pose_reg_weight))
    return out


def isdf_loss_default(model, batch, key=None, trunc_dist=0.15, trunc_weight=1.0,
                      eik_weight=0.0, eik_apply_dist=0.1, grad_weight=0.0,
                      free_space_factor=5.0, loss_type="L1", smooth_weight=0.0,
                      smooth_std=0.05):
    """The world-frame form (``batch['coords']``), with an optional cosine
    term between the field's gradient and the batch's ``normals`` at surface
    samples (bound 0)."""
    pc = batch["coords"]
    bounds = batch["sdf"]
    pred = model(pc)
    mat, free = isdf_sdf_loss_mat(pred, bounds, trunc_dist, loss_type, free_space_factor)
    total = torch.where(free, mat, mat * trunc_weight)
    g = None
    if eik_weight > 0 or grad_weight > 0:
        g = gradient3d(pc, model, method="autograd")
    if eik_weight > 0:
        total = total + eik_weight * _eikonal(model, pc, bounds, eik_apply_dist, g)
    out = {"sdf": torch.mean(total)}
    if grad_weight > 0 and "normals" in batch:
        n = batch["normals"]
        cos = torch.sum(g * n, dim=-1) / (
            torch.linalg.vector_norm(g, dim=-1) * torch.linalg.vector_norm(n, dim=-1) + 1e-6)
        surf = (torch.abs(bounds[:, 0]) < 1e-6).to(cos.dtype)
        out["grad"] = grad_weight * torch.sum((1.0 - cos) * surf) / torch.clamp(
            torch.sum(surf), min=1.0)
    if smooth_weight > 0:
        out["smooth"] = smooth_weight * common.smoothness_loss(
            model, pc, torch.ones_like(bounds), key, smooth_std)
    return out


def isdf_loss_submap(params, batch, key=None, trunc_dist=0.15, sdf_weight=1.0,
                     trunc_weight=1.0, eik_weight=0.0, eik_apply_dist=0.1,
                     free_space_factor=5.0, loss_type="L1", pose_reg_weight=0.0,
                     pose_thresh_rad=1.0, pose_thresh_m=1.0, stability_weight=0.0):
    """Independent per-submap iSDF losses over an atlas's params: each point
    queried in its own submap's frame (``forward_per_point``), each submap's
    mean over its own points; one loss entry per stacked slot."""
    ids = batch["sample_frame_ids"].reshape(-1).long()
    bounds = batch["sdf"]
    sub_of_point = params.kf_to_submap[ids]
    R_sk, t_sk = params.updated_kf_poses_in_submap()
    coords_submap = se3.transform_points_by_id2(batch["coords_frame"], sub_of_point,
                                                params.kf_to_local[ids], R_sk, t_sk)
    S = params.capacity
    pred = params.forward_per_point(sub_of_point, coords_submap)
    seg_ids = sub_of_point.long()

    def seg(v):  # (N,) per-point terms -> (S,) per-submap sums
        return torch.zeros((S,), dtype=v.dtype, device=v.device).index_add(0, seg_ids, v)

    counts = torch.clamp(seg(torch.ones_like(bounds[:, 0])), min=1.0)
    mat, free = isdf_sdf_loss_mat(pred, bounds, trunc_dist, loss_type, free_space_factor)
    mat = torch.where(free, mat, mat * trunc_weight)
    sdf_vec = sdf_weight * seg(mat[:, 0]) / counts
    if stability_weight > 0:
        mu = params.query_stability_per_point(sub_of_point, coords_submap)
        stab_vec = stability_weight * seg(torch.sum((mu - 1.0) ** 2, dim=1)) / counts
    if pose_reg_weight > 0:
        rot_norm = torch.linalg.vector_norm(params.kf_rot_corr, dim=-1)   # (S, K)
        tr_norm = torch.linalg.vector_norm(params.kf_trans_corr, dim=-1)
        tr_R = pose_reg_weight * torch.sum(torch.relu(rot_norm - pose_thresh_rad), dim=1)
        tr_t = pose_reg_weight * torch.sum(torch.relu(tr_norm - pose_thresh_m), dim=1)
    out = {}
    for s in range(S):
        out[f"submap{s}_sdf"] = sdf_vec[s]
        if stability_weight > 0:
            out[f"submap{s}_stability"] = stab_vec[s]
        if pose_reg_weight > 0:
            out[f"submap{s}_trust_region_R"] = tr_R[s]
            out[f"submap{s}_trust_region_t"] = tr_t[s]
    return out
