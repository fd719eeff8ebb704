"""Plain SDF supervision losses (port of ``miso_tpu/losses/sdf.py``).

``key`` is a ``torch.Generator`` on the model's device (or None for the
default generator): the eikonal's uniform points are drawn from it.
"""
from __future__ import annotations

import torch

from miso_tpu_torch.losses.common import eikonal_loss_uniform


def sdf_loss_2d(model, batch, key=None, sdf_weight=3e3):
    """Plain MSE."""
    pred = model(batch["coords"])
    return {"sdf": torch.mean((pred - batch["sdf"]) ** 2) * sdf_weight}


def sdf_loss_3d(model, batch, key=None, sdf_weight=3e3):
    """Masked MSE."""
    pred = model(batch["coords"])
    c = torch.where(batch["sdf_valid"] == 1, pred - batch["sdf"], torch.zeros_like(pred))
    return {"sdf": torch.mean(c ** 2) * sdf_weight}


def tsdf_loss_3d(model, batch, key=None, sdf_weight=3e3, sign_weight=1e2,
                 eik_weight=5e1, trunc_dist=0.15, grad_method="autograd",
                 finite_diff_eps=1e-2):
    """Masked MSE + truncation sign hinges + eikonal at uniform random points."""
    coords = batch["coords"]
    gt_sdf = batch["sdf"]
    valid = batch["sdf_valid"]
    sign = batch["sdf_sign"] if "sdf_sign" in batch else batch["sdf_signs"]
    pred = model(coords)
    zero = torch.zeros_like(pred)
    c = torch.where(valid == 1, pred - gt_sdf, zero)
    out = {"sdf": torch.mean(c ** 2) * sdf_weight}
    if sign_weight > 0:
        pos = torch.where(sign == 1, trunc_dist - pred, zero)
        out["pos_space"] = torch.mean(torch.relu(pos)) * sign_weight
        neg = torch.where(sign == -1, pred + trunc_dist, zero)
        out["neg_space"] = torch.mean(torch.relu(neg)) * sign_weight
    if eik_weight > 0:
        out["eik"] = eikonal_loss_uniform(
            model, model.bound, gt_sdf.shape[0], key, grad_method,
            finite_diff_eps) * eik_weight
    return out
