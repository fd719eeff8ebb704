"""MISO tracking and mapping losses on GridNet (port of
``miso_tpu/losses/miso.py``).

Keyframe ids in batches are global and become local pose rows through the
model's ``anchor_kf``; every point is moved to world coordinates by one
batched per-point transform (``ops/se3.py::transform_points_by_id``).
``key`` is accepted for the common loss signature; these losses draw no
random numbers.
"""
from __future__ import annotations

import functools

import torch

from miso_tpu_torch.losses import common
from miso_tpu_torch.ops import se3


def _coords_to_world(model, batch, pose_lock_rows=None):
    """Frame coords to world with the updated keyframe poses (batched)."""
    ids = batch["sample_frame_ids"].reshape(-1).long() - model.anchor_kf.long()
    R, t = model.updated_kf_poses(lock_mask=pose_lock_rows)
    return se3.transform_points_by_id(batch["coords_frame"], ids, R, t)


def tracking_loss(model, batch, key=None, weight_sdf=1.0, loss_type="L2",
                  trunc_dist=None, gm_scale_sdf=1.0, pose_lock_rows=None):
    """Masked SDF residual with an optional |gt| < trunc prefilter;
    L2 / L1 / Geman-McClure."""
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    if trunc_dist is not None:
        valid = valid * (torch.abs(gt_sdf) < trunc_dist).to(valid.dtype)
    coords_world = _coords_to_world(model, batch, pose_lock_rows)
    pred = model(coords_world)
    loss = common.sdf_residual_loss(pred, gt_sdf, valid, loss_type, gm_scale_sdf)
    return {f"sdf_{loss_type}": weight_sdf * loss}


def mapping_loss(model, batch, key=None, loss_type="L1", weight_sdf=1.0,
                 weight_eik=0.5, weight_fs=0.0, trunc_dist=0.0,
                 finite_diff_eps=1e-2, grad_method="autograd",
                 eik_trunc_dist=0.1, use_stability=False, weight_clip=0.0,
                 mask_bound=None, pose_lock_rows=None):
    """Weighted SDF regression + eikonal (|gt| < eik_trunc_dist) + free-space
    bound + optional CLIP-feature head (decoder channel 0 is the SDF,
    channels 1.. regress the batch's CLIP embeddings).

    mask_bound: if set (metres), rows outside the model bound eroded by this
    margin get zero weight.
    """
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    sign = batch["sdf_signs"]
    weights = batch.get("weights")
    coords_world = _coords_to_world(model, batch, pose_lock_rows)
    if mask_bound is not None:
        m = torch.tensor([mask_bound, -mask_bound], dtype=model.bound.dtype,
                         device=model.bound.device)
        inside = se3.coords_in_bound(coords_world, model.bound + m)
        valid = valid * inside
        sign = sign * inside
    model_out = model(coords_world)
    pred = model_out[:, :1]
    out = {}
    out[f"sdf_{loss_type}"] = common.regression_loss(
        pred, gt_sdf, valid, weights, loss_type) * weight_sdf
    if weight_eik > 0:
        sel = ((torch.abs(gt_sdf) < eik_trunc_dist).to(gt_sdf.dtype)
               if eik_trunc_dist is not None else None)
        out["eik"] = common.eikonal_loss_at(
            lambda xx: model(xx)[:, :1], coords_world, sel, grad_method,
            finite_diff_eps) * weight_eik
    if weight_fs > 0:
        out["free_space"] = common.free_space_loss(
            pred, gt_sdf, sign, trunc_dist) * weight_fs
    if use_stability:
        out.update(common.feature_stability_loss(model, coords_world))
    if weight_clip > 0 and "clip_coords_frame" in batch:
        ids = (batch["clip_sample_frame_ids"].reshape(-1).long()
               - model.anchor_kf.long())
        R, t = model.updated_kf_poses(lock_mask=pose_lock_rows)
        clip_world = se3.transform_points_by_id(batch["clip_coords_frame"], ids, R, t)
        pred_clip = model(clip_world)[:, 1:]
        out["clip_L1"] = common.regression_loss(
            pred_clip, batch["clip_embeddings"], None, None, "L1") * weight_clip
    return out


def posed_sdf_loss_3d(model, batch, key=None, sdf_weight=3e3, sign_weight=1e2,
                      eik_weight=0.0, smooth_weight=0.0, trunc_dist=0.15,
                      smooth_std=0.1, grad_method="autograd",
                      finite_diff_eps=1e-2, loss_type="L2",
                      with_stability=True, pose_lock_rows=None):
    """The posed-SDF (bundle-adjustment) loss of one GridNet: masked SDF
    residual, free space, eikonal at uniform points of the bound, gradient
    smoothness and feature stability.  ``key`` (a ``torch.Generator`` on the
    model's device) draws the eikonal's points, then the smoothness noise."""
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    sign = batch["sdf_signs"]
    coords_world = _coords_to_world(model, batch, pose_lock_rows)
    pred = model(coords_world)
    c = torch.where(valid == 1, pred - gt_sdf, torch.zeros_like(pred))
    if loss_type == "L2":
        sdf_loss = torch.mean(c ** 2)
    elif loss_type == "L1":
        sdf_loss = torch.mean(torch.abs(c))
    else:
        raise ValueError(f"Invalid loss type: {loss_type}")
    out = {"sdf": sdf_loss * sdf_weight}
    if sign_weight > 0:
        out["free_space"] = common.free_space_loss(pred, gt_sdf, sign, trunc_dist) * sign_weight
    if eik_weight > 0:
        out["eik"] = common.eikonal_loss_uniform(
            model, model.bound, gt_sdf.shape[0], key, grad_method,
            finite_diff_eps) * eik_weight
    if smooth_weight > 0:
        out["smooth"] = common.smoothness_loss(
            model, coords_world, valid, key, smooth_std, grad_method,
            finite_diff_eps) * smooth_weight
    if with_stability:
        out.update(common.feature_stability_loss(model, coords_world, valid))
    return out


def make_loss(fn, **fixed_kwargs):
    """Bind loss hyperparameters; returns (model, batch, key, **overrides) -> dict."""
    @functools.wraps(fn)
    def bound_loss(model, batch, key=None, **overrides):
        return fn(model, batch, key, **{**fixed_kwargs, **overrides})
    return bound_loss
