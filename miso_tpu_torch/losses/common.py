"""Shared loss helpers (port of ``miso_tpu/losses/common.py``).

Losses are functions ``(model, batch, key) -> dict[str, scalar tensor]`` over
fixed-shape batches.  Validity is a multiplicative mask, never boolean
indexing, and means run over the full batch including masked-out entries,
as in the JAX package.

Inside :func:`batch_axis` (the data-parallel steps of
``parallel/sharding.py``) each rank holds its rows of the batch, and the
helpers whose value is not a plain mean over rows take the global batch:
a ratio of sums adds its numerator and denominator over the ranks, and
the eikonal's uniform draw is made for the global batch, each rank keeping
its rows.  Plain means are averaged over the ranks by the step itself.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from miso_tpu_torch.ops.diff import gradient3d


_BATCH_AXIS = contextvars.ContextVar("batch_axis", default=None)


@contextlib.contextmanager
def batch_axis(axis):
    """Within the block the batch is sharded over ``axis`` (a
    ``parallel/sharding.py::Axis``; None: not sharded)."""
    token = _BATCH_AXIS.set(axis if axis is not None and axis.group is not None else None)
    try:
        yield
    finally:
        _BATCH_AXIS.reset(token)


def _ratio(num, den):
    """num / max(den, 1), both sums over the batch: over the global batch
    inside :func:`batch_axis` (summed over the ranks, the quotient handed
    back to each rank's share of the loss)."""
    ax = _BATCH_AXIS.get()
    if ax is None:
        return num / torch.clamp(den, min=1.0)
    nd = ax.psum(torch.stack([num, den.to(num.dtype)]))
    return ax.pvary(nd[0] / torch.clamp(nd[1], min=1.0))


def masked_mean(values, mask=None):
    """Mean with an explicit valid-count denominator (for subset means)."""
    if mask is None:
        return torch.mean(values)
    return _ratio(torch.sum(values * mask), torch.sum(mask) * (values.numel() / mask.numel()))


def regression_loss(pred, targ, valid_mask=None, sample_weights=None,
                    loss_type="L1"):
    """Per-row L2 / L1 / cosine regression, masked, weighted, full-batch mean."""
    if pred.shape != targ.shape:
        raise ValueError(f"pred {tuple(pred.shape)} vs targ {tuple(targ.shape)}")
    n = pred.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones((n, 1), dtype=pred.dtype, device=pred.device)
    if sample_weights is None:
        sample_weights = torch.ones((n, 1), dtype=pred.dtype, device=pred.device)
    if loss_type == "L2":
        vec = torch.sum((pred - targ) ** 2, dim=1, keepdim=True)
    elif loss_type == "L1":
        vec = torch.sum(torch.abs(pred - targ), dim=1, keepdim=True)
    elif loss_type == "Cosine":
        num = torch.sum(pred * targ, dim=1, keepdim=True)
        den = (torch.linalg.vector_norm(pred, dim=1, keepdim=True)
               * torch.linalg.vector_norm(targ, dim=1, keepdim=True))
        vec = 1.0 - num / torch.clamp(den, min=1e-8)
    else:
        raise ValueError(f"Invalid loss type: {loss_type}")
    vec = torch.where(valid_mask == 1, vec, torch.zeros_like(vec))
    return torch.mean(sample_weights * vec)


def gm_weighted_sq(residual, gm_scale):
    """Geman-McClure IRLS: w = c / (c + e^2)^2 with e detached."""
    e = residual.detach()
    w = gm_scale / (gm_scale + e ** 2) ** 2
    return w * residual ** 2


def sdf_residual_loss(pred_sdf, gt_sdf, valid_mask, loss_type="L2", gm_scale=1.0):
    """Masked SDF residual under L2 / L1 / GM."""
    diff = pred_sdf - gt_sdf
    c = torch.where(valid_mask == 1, diff, torch.zeros_like(diff))
    if loss_type == "L2":
        return torch.mean(c ** 2)
    if loss_type == "L1":
        return torch.mean(torch.abs(c))
    if loss_type == "GM":
        return torch.mean(gm_weighted_sq(c, gm_scale))
    raise ValueError(f"Invalid loss type: {loss_type}")


def free_space_loss(pred_sdf, gt_sdf, gt_sdf_sign, trunc_dist):
    """max(relu(pred - gt), relu(trunc - pred)) in declared free space,
    mean over the full batch."""
    is_free = gt_sdf_sign == 1
    zero = torch.zeros_like(pred_sdf)
    upper = torch.where(is_free, torch.relu(pred_sdf - gt_sdf), zero)
    lower = torch.where(is_free, torch.relu(trunc_dist - pred_sdf), zero)
    return torch.mean(torch.maximum(upper, lower))


def eikonal_loss_at(model_fn, coords, select_mask=None,
                    grad_method="autograd", finite_diff_eps=1e-2):
    """||grad|| -> 1 penalty; ``select_mask`` (N, 1) means over a subset."""
    g = gradient3d(coords, model_fn, method=grad_method,
                   finite_diff_eps=finite_diff_eps)
    c = (torch.linalg.vector_norm(g, dim=-1, keepdim=True) - 1.0) ** 2
    if select_mask is None:
        return torch.mean(c)
    return _ratio(torch.sum(c * select_mask), torch.sum(select_mask))


def eikonal_loss_uniform(model_fn, bound, n, generator=None, grad_method="autograd",
                         finite_diff_eps=1e-2):
    """Eikonal at n uniform random points in the bound.

    The points are drawn from ``generator`` (a ``torch.Generator`` on the
    bound's device, in place of the JAX key; the default generator when None),
    so their stream differs from the JAX package's.  Inside :func:`batch_axis`
    ``n`` is this rank's share: the draw is made for the global batch and the
    rank keeps its rows, the points of the unsharded draw.
    """
    ax = _BATCH_AXIS.get()
    if ax is None:
        u = torch.rand((n, 3), generator=generator, dtype=bound.dtype, device=bound.device)
    else:
        u = torch.rand((n * ax.size, 3), generator=generator, dtype=bound.dtype,
                       device=bound.device)[ax.index * n:(ax.index + 1) * n]
    coords = bound[:, 0] + u * (bound[:, 1] - bound[:, 0])
    return eikonal_loss_at(model_fn, coords, None, grad_method, finite_diff_eps)


def smoothness_loss(model_fn, coords, valid_mask, key=None, smooth_std=0.1,
                    grad_method="autograd", finite_diff_eps=1e-2):
    """GO-SURF's gradient smoothness: the field's spatial gradient at the
    points against its gradient at the points moved by N(0, smooth_std^2)
    noise, masked, full-batch mean of the squared difference.

    The noise is drawn from ``key`` (a ``torch.Generator`` on the points'
    device; the default generator when None), so its stream differs from the
    JAX package's.
    """
    noise = torch.randn(coords.shape, generator=key, dtype=coords.dtype,
                        device=coords.device) * smooth_std
    g1 = gradient3d(coords, model_fn, method=grad_method, finite_diff_eps=finite_diff_eps)
    g2 = gradient3d(coords + noise, model_fn, method=grad_method,
                    finite_diff_eps=finite_diff_eps)
    c = torch.where(valid_mask == 1, g1 - g2, torch.zeros_like(g1))
    return torch.mean(c ** 2)


def feature_stability_loss(model, coords, mask_valid=None):
    """Drive interpolated stability to 1 at observed points, plus an L2
    regulariser on the stability grids."""
    if mask_valid is None:
        mask_valid = torch.ones((coords.shape[0], 1), dtype=coords.dtype,
                                device=coords.device)
    mu = model.query_stability(coords)
    c = torch.where(mask_valid == 1, mu - 1.0, torch.zeros_like(mu))
    out = {"stability": torch.mean(c ** 2)}
    for level in range(model.num_levels):
        out[f"stability_reg_level{level}"] = 1e-2 * torch.mean(model.stability[level] ** 2)
    return out


def pose_regularization_loss(rot_corr, trans_corr, weight=1.0):
    """L2 on pose corrections."""
    return {
        "pose_l2_reg_R": weight * torch.mean(rot_corr ** 2),
        "pose_l2_reg_t": weight * torch.mean(trans_corr ** 2),
    }


def pose_trust_region_loss(rot_corr, trans_corr, thresh_rad, thresh_m, weight=1e3):
    """Trust-region hinge on pose-correction norms."""
    rot_norm = torch.linalg.vector_norm(rot_corr, dim=-1)
    tr_norm = torch.linalg.vector_norm(trans_corr, dim=-1)
    return {
        "trust_region_R": weight * torch.sum(torch.relu(rot_norm - thresh_rad)),
        "trust_region_t": weight * torch.sum(torch.relu(tr_norm - thresh_m)),
    }


def info_nce_loss(query, positive, mask=None, temperature=0.1):
    """InfoNCE between per-point feature pairs: each query's positive is its
    own row of ``positive``, every other row a negative.  ``mask`` (..., N) or
    (..., N, 1) drops rows from both the anchors and the negatives.

    query, positive: (N, D) give one loss; (B, N, D) give B independent
    losses (B,), one (N, N) softmax each (the alignment's per-pair loss).  A
    batch with no unmasked row gives exactly 0 and a zero gradient."""
    q = query / (torch.linalg.vector_norm(query, dim=-1, keepdim=True) + 1e-8)
    p = positive / (torch.linalg.vector_norm(positive, dim=-1, keepdim=True) + 1e-8)
    logits = torch.matmul(q, p.transpose(-1, -2)) / temperature        # (..., N, N)
    if mask is not None:
        m = mask.reshape(query.shape[:-1]).to(logits.dtype)
        logits = torch.where(m.unsqueeze(-2) > 0, logits, torch.full_like(logits, -1e9))
    nll = -torch.diagonal(torch.log_softmax(logits, dim=-1), dim1=-2, dim2=-1)   # (..., N)
    if mask is None:
        return torch.mean(nll, dim=-1)
    return torch.sum(nll * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)


def total_loss(loss_dict):
    """Sum of the loss dict's means."""
    return sum(torch.mean(v) for v in loss_dict.values())
