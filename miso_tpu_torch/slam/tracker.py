"""Frame-to-model tracking on the current submap's GridNet (port of
``miso_tpu/slam/tracker.py``).

Two solvers:

  * ``"lm"``: Levenberg-Marquardt with Geman-McClure (or L2) IRLS weights.
    One step queries the SDF and its spatial gradient with the grid frozen
    (``GridNet.forward(x, frozen=True)`` and one backward to the points: on
    the card one interp forward per level, one decode, and one points-only
    interp backward per level, which scatters no table gradient), builds the
    (N, 6) Jacobian, solves the damped 6x6 normal equations and clamps the
    step to a trust region.  :func:`lm_solve` runs a whole registration over
    pre-sampled batches with the tolerance freeze kept on the device and
    reads the host once, at the end.
  * ``"adam"``: window tracking through the masked trainer, features locked,
    only the target keyframes' pose rows trainable.

Boolean prefilters (|gt| < trunc) are zero row weights in the normal
equations.  The normal equations and the 3x3 products are elementwise sums
in float32 (no TF32, whatever the process's matmul settings).
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from miso_tpu_torch.losses.miso import make_loss, tracking_loss
from miso_tpu_torch.models.grid_net import GridNet, grid_net_mask
from miso_tpu_torch.ops import se3
from miso_tpu_torch.train.trainer import Trainer


def _lm_core(grid: GridNet, rot_row, trans_row, coords_frame, gt_sdf, gt_valid,
             kf_local: int, lm_lambda, gm_scale, trunc_dist_or_inf, loss_type,
             max_step_rad=math.inf, max_step_m=math.inf):
    """One LM update of keyframe ``kf_local`` whose correction rows are
    (rot_row, trans_row): returns (d_rot (3,), d_t (3,), info dict of scalar
    tensors)."""
    dtype = coords_frame.dtype
    w_rows = gt_valid * (torch.abs(gt_sdf) < trunc_dist_or_inf).to(dtype)
    Rwf, twf = se3.apply_pose_correction(grid.Rwk[kf_local], grid.twk[kf_local],
                                         rot_row, trans_row)
    coords_world = se3.transform_points_to(coords_frame, Rwf, twf)
    mask_bnd = se3.coords_in_bound(coords_world, grid.bound)
    denom = torch.clamp(torch.sum(w_rows), min=1.0)
    fov_overlap = torch.sum(mask_bnd * w_rows) / denom
    # Rows outside the bound eroded by one coarse cell get no weight: there
    # the zero-padded features give a constant SDF with a false gradient ramp
    # in the boundary shell, which would pull the solve toward the faces.
    margin = grid.cell_sizes[0] if grid.cell_sizes else 0.0
    bound_eroded = grid.bound + torch.tensor([margin, -margin], dtype=grid.bound.dtype,
                                             device=grid.bound.device)
    w_rows = w_rows * se3.coords_in_bound(coords_world, bound_eroded)
    # The SDF and its spatial gradient, the grid frozen: one forward, one
    # backward to the points only.
    with torch.enable_grad():
        x = coords_world.detach().requires_grad_()
        sdf = grid(x, frozen=True)
        (grad_world,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf))
    # J = [(hat(R x) grad) R, grad]  (N, 6).
    Rxi = se3.transform_points_to(coords_frame, Rwf, torch.zeros_like(twf))
    cT = (se3.hat(Rxi) * grad_world.unsqueeze(-2)).sum(-1)
    cTR = (cT.unsqueeze(-1) * Rwf).sum(-2)
    J = torch.cat([cTR, grad_world], dim=1)
    r = sdf.detach() - gt_sdf
    if loss_type == "GM":
        w = gm_scale / (gm_scale + r ** 2) ** 2
    else:  # L2
        w = torch.ones_like(r)
    w = w * w_rows
    # Weighted 6x6 normal equations, damped.
    H = (J.unsqueeze(2) * (w * J).unsqueeze(1)).sum(0) \
        + lm_lambda * torch.eye(6, dtype=dtype, device=J.device)
    g = (J * (w * r)).sum(0, keepdim=True).T
    delta = torch.linalg.solve(H, -g).reshape(6)
    d_rot, d_t = delta[:3], delta[3:]
    # Trust-region clamp of each part of the step.
    rn = torch.linalg.vector_norm(d_rot)
    tn = torch.linalg.vector_norm(d_t)
    d_rot = d_rot * torch.clamp(max_step_rad / torch.clamp(rn, min=1e-12), max=1.0)
    d_t = d_t * torch.clamp(max_step_m / torch.clamp(tn, min=1e-12), max=1.0)
    info = {
        "delta_R_rad": torch.clamp(rn, max=max_step_rad),
        "delta_t_norm": torch.clamp(tn, max=max_step_m),
        "grad_norm": torch.linalg.vector_norm(g),
        "fov_overlap": fov_overlap,
    }
    return d_rot, d_t, info


@torch.no_grad()
def lm_step(grid: GridNet, coords_frame, gt_sdf, gt_valid, kf_local: int,
            lm_lambda, gm_scale, trunc_dist_or_inf, loss_type="GM",
            max_step_rad=math.inf, max_step_m=math.inf):
    """One LM registration step; updates the keyframe's correction rows in
    place.  Returns (grid, info)."""
    d_rot, d_t, info = _lm_core(grid, grid.rot_corr[kf_local], grid.trans_corr[kf_local],
                                coords_frame, gt_sdf, gt_valid, kf_local, lm_lambda,
                                gm_scale, trunc_dist_or_inf, loss_type,
                                max_step_rad, max_step_m)
    grid.rot_corr[kf_local] += d_rot
    grid.trans_corr[kf_local] += d_t
    return grid, info


@torch.no_grad()
def lm_solve(grid: GridNet, coords_frames, gt_sdfs, gt_valids, kf_local: int,
             lm_lambda, gm_scale, trunc_dist_or_inf, tol_rad, tol_m,
             loss_type="GM", max_step_rad=math.inf, max_step_m=math.inf):
    """A whole LM registration: one step per pre-sampled batch (leading axis
    k of the stacked inputs).  Once a step's deltas fall under both
    tolerances, later steps leave the pose as it is (a freeze kept on the
    device, so the loop never waits for the host).

    Returns (rot_row, trans_row, infos): the keyframe's final correction rows
    (the grid is not changed) and each info stacked over the k steps;
    ``infos['fov_overlap'][0]`` is the overlap at the initial pose.
    """
    rot_row = grid.rot_corr[kf_local].clone()
    trans_row = grid.trans_corr[kf_local].clone()
    stopped = torch.zeros((), dtype=torch.bool, device=rot_row.device)
    infos: Dict[str, list] = {}
    for c, s, v in zip(coords_frames, gt_sdfs, gt_valids):
        d_rot, d_t, info = _lm_core(grid, rot_row, trans_row, c, s, v, kf_local,
                                    lm_lambda, gm_scale, trunc_dist_or_inf, loss_type,
                                    max_step_rad, max_step_m)
        live = torch.logical_not(stopped).to(d_rot.dtype)
        rot_row = rot_row + d_rot * live
        trans_row = trans_row + d_t * live
        converged = (info["delta_R_rad"] < tol_rad) & (info["delta_t_norm"] < tol_m)
        stopped = stopped | converged
        for k, val in info.items():
            infos.setdefault(k, []).append(val)
    return rot_row, trans_row, {k: torch.stack(v) for k, v in infos.items()}


class Tracker:
    """Tracks keyframes against ``model`` (a GridNet, updated in place) with
    the settings of ``cfg['tracking']``."""

    def __init__(self, model: GridNet, dataset, cfg: Dict):
        self.grid = model
        self.dataset = dataset
        self.cfg = cfg
        c = cfg["tracking"]
        self.lr = c.get("learning_rate", 1e-3)
        self.verbose = c.get("verbose", False)
        self.gm_scale_sdf = c.get("gm_scale_sdf", 1.0)
        self.lm_lambda = c.get("lm_lambda", 1e-4)
        self.lm_max_iter = c.get("lm_max_iter", 10)
        self.lm_tol_deg = c.get("lm_tol_deg", 0.01)
        self.lm_tol_m = c.get("lm_tol_m", 0.001)
        # Per-step trust region (see _lm_core); defaults that a healthy
        # solve never reaches.
        self.lm_max_step_deg = c.get("lm_max_step_deg", 10.0)
        self.lm_max_step_m = c.get("lm_max_step_m", 1.0)
        self.loss_type = c.get("loss_type", "GM")
        self.trunc_dist = c.get("trunc_dist", None)
        self.solver = c.get("solver", "lm")
        # tracking.lm_scan: false takes the per-step loop with a host read of
        # each step's deltas and an early exit.
        self.lm_scan = bool(c.get("lm_scan", True))
        self.disable = bool(c.get("disable", False))
        self.latest_fov_overlap = 1.0
        self.initial_fov_overlap = 1.0
        self.last_sample_time = 0.0
        self._warned_overlap = False
        self._rng = np.random.default_rng(c.get("seed", 0))
        self._tracking_loss_fn = make_loss(
            tracking_loss, weight_sdf=1.0, loss_type=self.loss_type,
            trunc_dist=self.trunc_dist, gm_scale_sdf=self.gm_scale_sdf)

    @property
    def device(self) -> torch.device:
        return self.grid.bound.device

    # -- odometry propagation ------------------------------------------------
    def initialize_window(self, head_kf: int, tail_kf: int):
        """Initial poses of keyframes head_kf .. tail_kf - 1, each the
        previous keyframe's corrected pose composed with the odometry."""
        anchor = int(self.grid.anchor_kf)
        for dst in range(head_kf, tail_kf):
            src = dst - 1
            R_src, t_src = self.grid.updated_kf_pose(src - anchor)
            T_ws = se3.pose_matrix(R_src, t_src).cpu().numpy()
            T_wd = T_ws @ np.asarray(self.dataset.get_odometry_at_pose(src))
            self.grid.set_initial_kf_pose(dst - anchor, T_wd[:3, :3], T_wd[:3, 3])

    # -- solvers -------------------------------------------------------------
    def track(self, optimize_kf: int):
        if self.disable:
            return
        if self.solver == "adam":
            self.track_window([optimize_kf], iterations=15)
        elif self.solver == "lm":
            self.track_lm(optimize_kf)
        else:
            raise ValueError(f"Unknown solver: {self.solver}")
        # A clipped submap bound starves the tracker of constraints; judge it
        # at the odometry-initialised pose and say so once.
        if self.initial_fov_overlap < 0.9 and not self._warned_overlap:
            self._warned_overlap = True
            warnings.warn(
                f"Tracking kf {optimize_kf}: only {self.initial_fov_overlap:.0%} of "
                "frame points fall inside the submap bound at the "
                "odometry-initialized pose. If this is not an intentional submap "
                "transition, enlarge system.submap_local_bound.")

    def _lm_args(self):
        trunc = self.trunc_dist if self.trunc_dist is not None else math.inf
        ltype = self.loss_type if self.loss_type in ("GM", "L2") else "L2"
        return dict(lm_lambda=float(self.lm_lambda), gm_scale=float(self.gm_scale_sdf),
                    trunc_dist_or_inf=float(trunc), loss_type=ltype,
                    max_step_rad=math.radians(self.lm_max_step_deg),
                    max_step_m=float(self.lm_max_step_m))

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def track_lm(self, optimize_kf: int):
        self.dataset.select_keyframes([optimize_kf])
        kf_local = optimize_kf - int(self.grid.anchor_kf)
        args = self._lm_args()
        if self.lm_scan and self.lm_max_iter >= 1 and not self.verbose:
            t0 = time.perf_counter()
            batches = [self.dataset.sample(self._rng) for _ in range(self.lm_max_iter)]

            def stack(k):
                return self._to_device(np.stack([b[k] for b in batches]))
            coords, sdf, valid = stack("coords_frame"), stack("sdf"), stack("sdf_valid")
            self.last_sample_time = time.perf_counter() - t0
            rot_row, trans_row, infos = lm_solve(
                self.grid, coords, sdf, valid, kf_local,
                tol_rad=math.radians(self.lm_tol_deg), tol_m=float(self.lm_tol_m), **args)
            with torch.no_grad():
                self.grid.rot_corr[kf_local] = rot_row
                self.grid.trans_corr[kf_local] = trans_row
            fov = infos["fov_overlap"].cpu().numpy()
            self.initial_fov_overlap = float(fov[0])
            self.latest_fov_overlap = float(fov[-1])
            return
        info = None
        for it in range(self.lm_max_iter):
            batch = self.dataset.sample(self._rng)
            self.grid, info = lm_step(
                self.grid, self._to_device(batch["coords_frame"]),
                self._to_device(batch["sdf"]), self._to_device(batch["sdf_valid"]),
                kf_local, **args)
            if it == 0:
                self.initial_fov_overlap = float(info["fov_overlap"])
            d_deg = math.degrees(float(info["delta_R_rad"]))
            d_m = float(info["delta_t_norm"])
            if self.verbose:
                print(f"LM step {it}: delta_deg={d_deg:.1e} delta_m={d_m:.1e}")
            if d_deg < self.lm_tol_deg and d_m < self.lm_tol_m:
                break
        self.latest_fov_overlap = float(info["fov_overlap"]) if info else 1.0

    def track_window(self, optimize_kfs: List[int], iterations=10):
        """Adam window tracking: features, stability and decoder locked, only
        the listed keyframes' pose rows trainable."""
        self.dataset.select_keyframes(optimize_kfs)
        anchor = int(self.grid.anchor_kf)
        rows = torch.zeros((self.grid.num_poses,), dtype=torch.float32)
        for kf in optimize_kfs:
            rows[kf - anchor] = 1.0
        mask = grid_net_mask(self.grid, features=False, stability=False,
                             decoder=False, pose=True, pose_rows=rows)
        cfg_train = {"verbose": self.verbose, "optimizer": "adam",
                     "learning_rate": self.lr, "epochs": iterations}
        trainer = Trainer(cfg_train, self.grid, self._tracking_loss_fn, self.dataset,
                          mask=mask)
        self.grid = trainer.train()
        # The overlap of the last keyframe's points with the bound.
        batch = self.dataset.sample(self._rng)
        R, t = self.grid.updated_kf_pose(optimize_kfs[-1] - anchor)
        pts = se3.transform_points_to(self._to_device(batch["coords_frame"]), R, t)
        self.latest_fov_overlap = float(torch.mean(se3.coords_in_bound(pts, self.grid.bound)))
        self.initial_fov_overlap = self.latest_fov_overlap
