"""Alignment baselines (port of ``miso_tpu/align/baselines.py``): the
VoxFusion++ and MIPS-Fusion pair losses, and classical ICP with a pose graph.

The two pair losses plug into
:func:`miso_tpu_torch.align.miso.generic_align_multiple_submaps` as the MISO
latent loss does: ``pair_loss(params, src, dst, generator, ctx)``.  They
query each submap through the atlas's slot views (``forward_submap``,
``query_stability_submap``; no copy of the tables per query).  Their
subsample draws with replacement (``torch.randint`` on the pair's
generator), as ``jax.random.choice`` does by default there; the MISO losses
draw without.  MIPS's SDF gradients are taken on detached points with
``create_graph=False`` and used as constants, which is what the JAX
package's ``stop_gradient`` gives: the same values and pose gradients, and
no second-order pass through the interpolation.

The ICP baseline extracts near-surface lattice points of each submap's
field, registers each overlapping pair with two-stage ICP on the host
(float64, ``utils/eval.py``), and solves a pose graph over the submap poses
(masked Adam at 1e-2, node 0 fixed, float32 on the atlas's device).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from miso_tpu_torch.align.miso import _pair_points
from miso_tpu_torch.models.grid_atlas import GridAtlas, GridAtlasParams
from miso_tpu_torch.ops import se3


def _draw(coords, gt_sdf, valid, gen, subsample_points):
    """``subsample_points`` rows drawn with replacement from ``gen`` (on the
    generator's device), or every row without a generator."""
    if subsample_points is None or gen is None:
        return coords, gt_sdf, valid
    n = coords.shape[0]
    idx = torch.randint(n, (min(subsample_points, n),), generator=gen,
                        device=gen.device).to(coords.device)
    return coords[idx], gt_sdf[idx], valid[idx]


def _stopped_gradient(f, x):
    """The spatial gradient of the scalar field ``f`` at ``x`` as a constant:
    first-order autograd on a detached copy of the points."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(f(xx).sum(), xx)
    return g


def pairwise_loss_vfpp(params: GridAtlasParams, atlas: GridAtlas, src: int, dst: int,
                       coords_src, gt_sdf, valid, sdf_weight=3000.0, use_bound=True,
                       stability_thresh=0.0, trunc_dist=0.15, key=None, subsample_points=None):
    """VoxFusion++ eq (9)-(10): src's observations (points in its frame and
    their SDF labels) moved into dst's frame; the squared residual of dst's
    decoded SDF against the labels, masked to valid labels inside the
    truncation (and dst's bound, and its observed cells past
    ``stability_thresh``), averaged over the whole batch, masked rows
    included."""
    coords_src, gt_sdf, valid = _draw(coords_src, gt_sdf, valid, key, subsample_points)
    coords_dst = _pair_points(params, coords_src, src, dst)
    mask = valid * (torch.abs(gt_sdf) < trunc_dist)
    if use_bound:
        mask = mask * se3.coords_in_bound(coords_dst, params.bounds[dst])
    if stability_thresh > 0:
        mu = torch.min(params.query_stability_submap(dst, coords_dst), dim=1,
                       keepdim=True).values
        mask = mask * (mu > stability_thresh)
    pred = params.forward_submap(dst, coords_dst)
    c = torch.where(mask == 1, pred - gt_sdf, 0.0)
    return {f"vfpp_{src}_{dst}": torch.mean(c ** 2) * sdf_weight}


def pairwise_loss_mips(params: GridAtlasParams, atlas: GridAtlas, src: int, dst: int,
                       coords_src, gt_sdf, valid, residual_weight=3000.0, use_bound=True,
                       constraint_type="point_to_plane", key=None, subsample_points=None,
                       surf_tol=1e-3):
    """MIPS-Fusion eq (19)-(22): for src's surface observations
    (|label| < ``surf_tol``), dst's correspondence ``match = p - sdf * grad``
    moved back into src's frame; the point-to-plane residual along src's
    field gradient (or the point-to-point one), squared and averaged over
    the masked rows."""
    coords_src, gt_sdf, valid = _draw(coords_src, gt_sdf, valid, key, subsample_points)
    R, t = params.updated_submap_poses()
    coords_dst = se3.transform_points_from(se3.transform_points_to(coords_src, R[src], t[src]),
                                           R[dst], t[dst])
    mask = valid * (torch.abs(gt_sdf) < surf_tol)
    if use_bound:
        mask = mask * se3.coords_in_bound(coords_dst, params.bounds[dst])
    grad_src = _stopped_gradient(lambda x: params.forward_submap(src, x), coords_src)
    sdf_dst = params.forward_submap(dst, coords_dst)
    grad_dst = _stopped_gradient(lambda x: params.forward_submap(dst, x), coords_dst)
    match_dst = coords_dst - sdf_dst * grad_dst                               # eq (19)
    match_src = se3.transform_points_from(se3.transform_points_to(match_dst, R[dst], t[dst]),
                                          R[src], t[src])
    if constraint_type == "point_to_plane":
        cons = torch.sum((coords_src - match_src) * grad_src, dim=1, keepdim=True)   # eq (20)
    elif constraint_type == "point_to_point":
        cons = coords_src - match_src
    else:
        raise ValueError(f"Invalid constraint type: {constraint_type}")
    c = torch.where(mask == 1, cons, 0.0)
    count = torch.clamp(torch.sum(mask), min=1.0)
    return {f"mips_{src}_{dst}": torch.sum(c ** 2) / count * residual_weight}


# ---------------------------------------------------------------------------
# Classical ICP and a pose graph
# ---------------------------------------------------------------------------

def extract_near_surface_points(atlas: GridAtlas, s: int, resolution=48, surf_thresh=0.05,
                                margin: Optional[float] = None) -> np.ndarray:
    """Lattice points of submap s (in its frame) whose field is under
    ``surf_thresh`` in magnitude, on a ``resolution``^3 lattice over its bound
    shrunk by ``margin`` (default one coarse cell): past the bound the zeros
    padding decays the field across any threshold, which would add surface
    points that only one submap has."""
    from miso_tpu_torch.utils.sdf import extract_fields

    sub = atlas.get_submap(s)
    if margin is None:
        margin = float(max(sub.cell_sizes))
    b = sub.bound.detach().cpu().numpy().copy()
    b[:, 0] += margin
    b[:, 1] -= margin
    u = extract_fields(sub, b, resolution)
    ax = [np.linspace(b[i, 0], b[i, 1], resolution) for i in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    mask = np.abs(u) < surf_thresh
    return np.stack([X[mask], Y[mask], Z[mask]], axis=-1).astype(np.float32)


def _pose_graph_optimize(n: int, edges: List[Tuple[int, int, np.ndarray]], T_init: np.ndarray,
                         iters=50, lr=0.0, device="cuda"):
    """Pose-graph optimisation over SE(3): rotation and translation
    corrections of the n poses ``T_init`` (n, 4, 4) minimise, over the edges
    (i, j, T_ij), ||log(T_ij.R^T R_i^T R_j)||^2 + ||R_i^T (t_j - t_i) -
    T_ij.t||^2.  Masked Adam at 1e-2 (``lr`` is not used, as in the JAX
    package), node 0 fixed, ``iters`` steps in float32 on ``device``.
    Returns the (n, 4, 4) poses."""
    from miso_tpu_torch.train.optim import masked_adam_init, masked_adam_update

    dev = torch.device(device)
    R0 = torch.as_tensor(np.asarray(T_init[:, :3, :3], np.float32), device=dev)
    t0 = torch.as_tensor(np.asarray(T_init[:, :3, 3], np.float32), device=dev)
    edge_T = torch.as_tensor(np.stack([e[2] for e in edges]).astype(np.float32), device=dev)
    edge_ij = [(int(e[0]), int(e[1])) for e in edges]

    def poses(p):
        return se3._mm(R0, se3.so3_exp(p["dr"])), t0 + p["dt"]

    def residual(p):
        R, t = poses(p)
        res = 0.0
        for k, (i, j) in enumerate(edge_ij):
            Rij = se3._mm(R[i].T, R[j])
            tij = torch.sum(R[i] * (t[j] - t[i])[:, None], dim=0)       # R_i^T (t_j - t_i)
            dR = se3._mm(edge_T[k, :3, :3].T, Rij)
            res = res + torch.sum(se3.so3_log(dR[None]) ** 2) \
                + torch.sum((tij - edge_T[k, :3, 3]) ** 2)
        return res

    p = {"dr": torch.zeros((n, 3), device=dev, requires_grad=True),
         "dt": torch.zeros((n, 3), device=dev, requires_grad=True)}
    opt = masked_adam_init(p)
    row = torch.ones((n, 1), device=dev)
    row[0] = 0.0
    mask = {"dr": row, "dt": row}
    for _ in range(iters):
        g = dict(zip(p, torch.autograd.grad(residual(p), list(p.values()))))
        masked_adam_update(g, opt, p, mask, lr=1e-2)
    with torch.no_grad():
        R, t = poses(p)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = R.cpu().numpy()
    T[:, :3, 3] = t.cpu().numpy()
    return T


def align_multiple_submaps_icp(atlas: GridAtlas, resolution=48, surf_thresh=0.05,
                               max_corr_coarse=0.5, max_corr_fine=0.1, pose_graph_iters=100,
                               min_fitness=0.1, clouds=None, min_overlap_points=100,
                               constraint="point_to_plane"):
    """Classical baseline: two-stage (coarse, fine) ICP of each overlapping
    pair's near-surface clouds, then the pose graph over every submap pose;
    writes the optimised poses of submaps 1.. into the atlas.

    ``clouds``: per-submap near-surface points in each submap's frame
    (default :func:`extract_near_surface_points`).  Each pair is cropped to
    the two bounds' overlap box in i's frame, shrunk by the coarser cell: the
    submaps overlap only in part, and uncropped ICP pulls towards maximum
    overlap rather than the true pose.  Point-to-plane takes the target
    normals from i's field gradient.  Returns {"num_edges": ...}."""
    from miso_tpu_torch.utils.eval import icp_point_to_plane, icp_point_to_point

    S = atlas.num_submaps
    if clouds is None:
        clouds = [extract_near_surface_points(atlas, s, resolution, surf_thresh)
                  for s in range(S)]
    with torch.no_grad():
        Rw, tw = (a.cpu().numpy() for a in atlas.params.updated_submap_poses())
    T_init = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    T_init[:, :3, :3] = Rw[:S]
    T_init[:, :3, 3] = tw[:S]
    bounds = atlas.params.bounds.cpu().numpy()
    edges = []
    for i in range(S):
        for j in range(i + 1, S):
            if not atlas.check_submap_intersection(i, j):
                continue
            T_ij0 = np.linalg.inv(T_init[i]) @ T_init[j]
            src = clouds[j] @ T_ij0[:3, :3].T + T_ij0[:3, 3]             # j in i's frame
            bi, bj = bounds[i], bounds[j]
            cj = np.array([[bj[0, a], bj[1, b], bj[2, c]] for a in range(2) for b in range(2)
                           for c in range(2)], np.float32)
            cj = cj @ T_ij0[:3, :3].T + T_ij0[:3, 3]
            shrink = float(max(atlas.params.cell_sizes))   # the submaps share their cells
            lo = np.maximum(bi[:, 0], cj.min(0)) + shrink
            hi = np.minimum(bi[:, 1], cj.max(0)) - shrink
            dst_c = clouds[i][np.all((clouds[i] >= lo) & (clouds[i] <= hi), 1)]
            src = src[np.all((src >= lo) & (src <= hi), 1)]
            if len(src) < min_overlap_points or len(dst_c) < min_overlap_points:
                continue
            if constraint == "point_to_plane":
                sub = atlas.get_submap(i)
                g = _stopped_gradient(lambda x: sub(x, frozen=True),
                                      torch.as_tensor(dst_c, device=atlas.device)).cpu().numpy()
                nrm = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
                T1, _, fit1 = icp_point_to_plane(src, dst_c, nrm, max_corr_dist=max_corr_coarse)
                T2, _, fit2 = icp_point_to_plane(src @ T1[:3, :3].T + T1[:3, 3], dst_c, nrm,
                                                 max_corr_dist=max_corr_fine)
            else:
                T1, _, fit1 = icp_point_to_point(src, dst_c, max_corr_dist=max_corr_coarse)
                T2, _, fit2 = icp_point_to_point(src @ T1[:3, :3].T + T1[:3, 3], dst_c,
                                                 max_corr_dist=max_corr_fine)
            if max(fit1, fit2) < min_fitness:
                continue
            edges.append((i, j, (T2 @ T1 @ T_ij0).astype(np.float32)))
    info = {"num_edges": len(edges)}
    if not edges:
        return info
    T_opt = _pose_graph_optimize(S, edges, T_init, iters=pose_graph_iters, device=atlas.device)
    for s in range(1, S):
        atlas.set_submap_pose(s, T_opt[s, :3, :3], T_opt[s, :3, 3])
    return info
