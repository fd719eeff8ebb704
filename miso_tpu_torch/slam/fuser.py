"""Global consistency of the submaps: alignment, then a joint fusion
refinement (port of ``miso_tpu/slam/fuser.py``).

``align()`` runs the hierarchical latent alignment with the config's
``align:`` section.  ``fuse()`` refines the features, submap poses and
keyframe poses together, each group at its own learning rate: the rates are
mask multipliers on one masked Adam of base rate 1.  The live slots are
trimmed out of the atlas for the refinement and scattered back, so the
optimiser walks only them.  The JAX package's ``prewarm`` and
``_prewarmed_slots`` compile its step ahead of time on the TPU and have no
counterpart.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import torch

from miso_tpu_torch.align.miso import align_multiple_submaps_hierarchical
from miso_tpu_torch.losses.fusion import fusion_loss
from miso_tpu_torch.models.grid_atlas import GridAtlas, grid_atlas_mask
from miso_tpu_torch.train.optim import masked_adam_init
from miso_tpu_torch.utils.profiling import synchronize


class Fuser:
    def __init__(self, model: GridAtlas, dataset, cfg: Dict):
        self.atlas = model
        self.dataset = dataset
        self.cfg = cfg
        self.last_fuse_info = None

    def align(self):
        """The hierarchical alignment with ``cfg['align']``'s settings (the
        JAX Fuser's defaults where a key is absent)."""
        c = self.cfg["align"]
        return align_multiple_submaps_hierarchical(
            self.atlas,
            level_iters=c.get("level_iters", 100),
            finetune_iters=c.get("finetune_iters", 100),
            level_thresh=0,
            lr=c.get("learning_rate", 1e-2),
            align_loss=c.get("loss_type", "L2"),
            stability_thresh=c.get("stability_thresh", 0.0),
            subsample_points=c.get("subsample_points", None),
            latent_levels=c.get("latent_levels", None),
            skip_finetune=c.get("skip_finetune", True),
            pose_reg_weight=c.get("pose_reg_weight", 0.0),
            pose_thresh_m=c.get("pose_thresh_m", 10.0),
            pose_thresh_rad=math.radians(c.get("pose_thresh_deg", 45.0)),
            verbose=c.get("verbose", False),
            save_iterations=c.get("save_iterations", False),
            max_align_points=c.get("max_points", 32768),
        )

    def _fuse_loss(self):
        from miso_tpu_torch.losses.miso import make_loss

        c = self.cfg["mapping"]
        return make_loss(
            fusion_loss,
            loss_type=c.get("loss_type", "L1"),
            weight_sdf=c.get("weight_sdf", 1.0),
            weight_eik=c.get("weight_eik", 0.0),
            weight_fs=c.get("weight_fs", 0.1),
            trunc_dist=c.get("trunc_dist", 0.15),
            finite_diff_eps=c.get("finite_diff_eps", 1e-2),
            grad_method=c.get("grad_method", "autograd"),
            eik_trunc_dist=c.get("eik_trunc_dist", 0.1),
        )

    @staticmethod
    def _fuse_mask(params, feat_lr, submap_pose_lr, kf_pose_lr):
        return grid_atlas_mask(params, features=feat_lr > 0, stability=feat_lr > 0,
                               submap_pose=submap_pose_lr > 0, kf_pose=kf_pose_lr > 0,
                               anchor_first_submap=False, feature_lr=feat_lr,
                               submap_pose_lr=submap_pose_lr, kf_pose_lr=kf_pose_lr)

    def fuse(self, feat_lr=1e-3, submap_pose_lr=1e-4, kf_pose_lr=1e-4, iterations=10, seed=0,
             max_points_per_iter=2 ** 19):
        """Joint refinement, ``iterations`` steps of
        ``train/trainer.py::make_train_step_pool``: each draws
        ``max_points_per_iter`` rows uniformly over every keyframe's rows of
        the dataset's device pool, from a ``torch.Generator`` seeded by
        ``seed``.  Returns the last step's total loss; timings in
        ``last_fuse_info``."""
        from miso_tpu_torch.train.trainer import make_train_step_pool

        marks = {}
        t_all = time.perf_counter()
        dev = self.atlas.device
        self.dataset.unselect_keyframes()
        full = self.atlas.params
        t0 = time.perf_counter()
        params = full.trim(self.atlas.num_submaps).requires_grad_()
        synchronize(dev)
        marks["trim_sec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mask = self._fuse_mask(params, feat_lr, submap_pose_lr, kf_pose_lr)
        opt_state = masked_adam_init(params)
        marks["mask_init_sec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = make_train_step_pool(self._fuse_loss(), "adam")
        pool, _, n_rows, _ = self.dataset.device_pool(dev)
        k_live = int(getattr(self.dataset, "num_kfs", n_rows.shape[0]))
        synchronize(dev)
        marks["pool_sec"] = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        tl = None
        t0 = time.perf_counter()
        for i in range(iterations):
            params, opt_state, tl = step(params, opt_state, pool, n_rows, k_live, gen, mask,
                                         1.0, int(max_points_per_iter))
            if i == 0:
                synchronize(dev)
                marks["step0_sec"] = time.perf_counter() - t0
                t0 = time.perf_counter()
        synchronize(dev)
        t_step = time.perf_counter() - t0
        t0 = time.perf_counter()
        full.scatter_trimmed(params)
        synchronize(dev)
        marks["scatter_sec"] = time.perf_counter() - t0
        self.last_fuse_info = {"step_sec": t_step, "iterations": iterations,
                               "points_per_iter": max_points_per_iter,
                               "trimmed_slots": int(params.Rws.shape[0]),
                               "total_sec": time.perf_counter() - t_all, **marks}
        return float(tl)
