"""Atlas losses: the fusion mapping loss and the posed-SDF submap loss (port
of ``miso_tpu/losses/fusion.py``).

Keyframe ids in batches are global.  Pose composition and per-submap
selection are batched gathers over the atlas's ``kf_to_submap`` /
``kf_to_local`` tables, and per-submap terms are segment sums
(``index_add``) over each point's submap, as in the JAX package.
"""
from __future__ import annotations

import torch

from miso_tpu_torch.losses import common
from miso_tpu_torch.ops import se3


def fusion_loss(params, batch, key=None, loss_type="L1", weight_sdf=1.0, weight_eik=0.0,
                weight_fs=0.1, trunc_dist=0.15, finite_diff_eps=1e-2, grad_method="autograd",
                eik_trunc_dist=0.1, gm_scale_sdf=0.1):
    """The mapping loss over the whole atlas: each point moved to the world by
    its keyframe's pose, submap-in-world composed with keyframe-in-submap,
    then the atlas's masked-average field (its world query)."""
    ids = batch["sample_frame_ids"].reshape(-1)
    R, t = params.updated_kf_poses_in_world()
    coords_world = se3.transform_points_by_id(batch["coords_frame"], ids, R, t)
    pred = params(coords_world)
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    out = {f"sdf_{loss_type}": common.regression_loss(
        pred, gt_sdf, valid, batch.get("weights"), loss_type) * weight_sdf}
    if weight_eik > 0:
        sel = ((torch.abs(gt_sdf) < eik_trunc_dist).to(gt_sdf.dtype)
               if eik_trunc_dist is not None else None)
        out["eik"] = common.eikonal_loss_at(params, coords_world, sel, grad_method,
                                            finite_diff_eps) * weight_eik
    if weight_fs > 0:
        out["free_space"] = common.free_space_loss(pred, gt_sdf, batch["sdf_signs"],
                                                   trunc_dist) * weight_fs
    return out


def posed_sdf_loss_3d_submap(params, batch, key=None, mode="submap", sdf_weight=3e3,
                             sign_weight=1e2, smooth_weight=0.0, smooth_std=0.1,
                             trunc_dist=0.15, grad_method="finitediff", finite_diff_eps=1e-2,
                             loss_type="L2", pose_reg_weight=0.0):
    """The posed-SDF loss of an atlas.

    ``mode='world'``: the losses on the atlas's fused field at the world
    points.  ``mode='submap'``: independent losses per submap, each point
    queried in its own submap's frame (one slot-id interp call a level,
    ``forward_per_point``); a submap's mean takes the count of its points as
    denominator, and the loss dict has one entry per stacked slot.
    ``key`` (a ``torch.Generator``) draws the smoothness term's noise.
    """
    ids = batch["sample_frame_ids"].reshape(-1)
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    signs = batch["sdf_signs"]
    out = {}
    if mode == "world":
        R, t = params.updated_kf_poses_in_world()
        coords_world = se3.transform_points_by_id(batch["coords_frame"], ids, R, t)
        pred = params(coords_world)
        c = torch.where(valid == 1, pred - gt_sdf, torch.zeros_like(pred))
        out["sdf"] = (torch.mean(c ** 2) if loss_type == "L2"
                      else torch.mean(torch.abs(c))) * sdf_weight
        if sign_weight > 0:
            out["free_space"] = common.free_space_loss(pred, gt_sdf, signs,
                                                       trunc_dist) * sign_weight
        if smooth_weight > 0:
            out["smooth"] = common.smoothness_loss(
                params, coords_world, valid, key, smooth_std, grad_method,
                finite_diff_eps) * smooth_weight
    else:
        S = params.capacity
        idl = ids.long()
        sub_of_point = params.kf_to_submap[idl]
        R_sk, t_sk = params.updated_kf_poses_in_submap()
        coords_submap = se3.transform_points_by_id2(batch["coords_frame"], sub_of_point,
                                                    params.kf_to_local[idl], R_sk, t_sk)
        pred = params.forward_per_point(sub_of_point, coords_submap)
        seg_ids = sub_of_point.long()

        def seg(v):  # (N,) per-point terms -> (S,) per-submap sums
            return torch.zeros((S,), dtype=v.dtype, device=v.device).index_add(0, seg_ids, v)

        counts = torch.clamp(seg(torch.ones_like(gt_sdf[:, 0])), min=1.0)
        c = torch.where(valid == 1, pred - gt_sdf, torch.zeros_like(pred))
        per = c ** 2 if loss_type == "L2" else torch.abs(c)
        sdf_vec = seg(per[:, 0]) / counts * sdf_weight
        if sign_weight > 0:
            is_free = signs == 1
            zero = torch.zeros_like(pred)
            upper = torch.where(is_free, torch.relu(pred - gt_sdf), zero)
            lower = torch.where(is_free, torch.relu(trunc_dist - pred), zero)
            fs_vec = seg(torch.maximum(upper, lower)[:, 0]) / counts * sign_weight
        if pose_reg_weight > 0:
            reg_R = pose_reg_weight * torch.mean(params.kf_rot_corr ** 2, dim=(1, 2))
            reg_t = pose_reg_weight * torch.mean(params.kf_trans_corr ** 2, dim=(1, 2))
        for s in range(S):
            out[f"{s}_sdf"] = sdf_vec[s]
            if sign_weight > 0:
                out[f"{s}_free_space"] = fs_vec[s]
            if pose_reg_weight > 0:
                out[f"{s}_pose_l2_reg_R"] = reg_R[s]
                out[f"{s}_pose_l2_reg_t"] = reg_t[s]
    if pose_reg_weight > 0:
        out["submap_l2_reg_R"] = pose_reg_weight * torch.sum(params.sub_rot_corr ** 2)
        out["submap_l2_reg_t"] = pose_reg_weight * torch.sum(params.sub_trans_corr ** 2)
    return out
