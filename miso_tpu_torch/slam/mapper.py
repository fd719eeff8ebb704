"""Mapping on the current submap's GridNet (port of
``miso_tpu/slam/mapper.py``).

Features and stability train, poses are locked, the decoder trains unless it
is fixed; coarse to fine with the MISO mapping loss.  Two paths:

  * the pool burst (the default, as in the JAX package when
    ``mapping.weight_clip`` is 0): the level schedule of
    ``train/trainer.py::level_schedule`` becomes one mask a step, a fresh
    masked-Adam state, and every step's rows are drawn on the device from the
    dataset's resident pool (``device_pool``) with a ``torch.Generator`` on
    the card, so the burst never waits for the host;
  * ``GridTrainer`` (``mapping.one_dispatch: false`` or
    ``mapping.device_sampling: false``), which samples each batch on the host
    with numpy, as the JAX trainer does.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models.grid_net import GridNet, grid_net_mask
from miso_tpu_torch.train.trainer import (GridTrainer, level_schedule,
                                          make_train_burst_pool)


class Mapper:
    """Maps keyframes into ``model`` (a GridNet, trained in place) with the
    settings of ``cfg['mapping']``."""

    def __init__(self, model: GridNet, dataset, cfg: Dict):
        self.grid = model
        self.dataset = dataset
        self.cfg = cfg
        c = cfg["mapping"]
        self.lr = c.get("learning_rate", 1e-3)
        self.verbose = c.get("verbose", False)
        self.disable = bool(c.get("disable", False))
        self.last_sample_time = 0.0
        self._burst_seed = int(c.get("seed", 0))
        self._burst_gen = None
        self._mask_cache: Dict = {}
        self.loss_fn = make_loss(
            mapping_loss,
            loss_type=c.get("loss_type", "L1"),
            weight_sdf=c.get("weight_sdf", 1.0),
            weight_eik=c.get("weight_eik", 0.0),
            weight_fs=c.get("weight_fs", 0.0),
            trunc_dist=c.get("trunc_dist", 0.15),
            finite_diff_eps=c.get("finite_diff_eps", 1e-2),
            grad_method=c.get("grad_method", "finitediff"),
            eik_trunc_dist=c.get("eik_trunc_dist", 0.1),
            use_stability=c.get("use_stability", False),
            weight_clip=c.get("weight_clip", 0.0),
            mask_bound=c.get("mask_bound", None),
        )
        self._burst = make_train_burst_pool(self.loss_fn, "adam")

    def mapping(self, mapping_kfs: List[int], iterations=10, level_iterations=5):
        if self.disable:
            return
        self.dataset.select_keyframes(mapping_kfs)
        c = self.cfg["mapping"]
        device_sampling = c.get("device_sampling", c.get("weight_clip", 0.0) == 0.0)
        if (device_sampling and c.get("one_dispatch", True)
                and hasattr(self.dataset, "device_pool")):
            self._mapping_burst(iterations, level_iterations)
            return
        cfg_train = dict(self.cfg.get("train", {}))
        cfg_train.update({
            "epochs": iterations,
            "max_epochs_in_level": level_iterations,
            "learning_rate": self.lr,
            "verbose": self.verbose,
            "optimizer": "adam",
            "grid_training_mode": cfg_train.get("grid_training_mode", "coordinate+joint"),
            "eval_every": -1,
            "ckpt_every": -1,
        })

        def mask_for_level(model, level):
            # Features and stability at the level, poses locked, the decoder
            # as decoder.fix says.
            return grid_net_mask(model, level=level, pose=False)

        trainer = GridTrainer(cfg_train, self.grid, self.loss_fn, self.dataset,
                              mask_for_level=mask_for_level)
        self.grid = trainer.train()
        self.last_sample_time = trainer.sample_time

    def _mapping_burst(self, iterations: int, level_iterations: int):
        """The whole burst on the device: one mask a step from the level
        schedule, batches drawn from the resident pool."""
        device = self.grid.bound.device
        t0 = time.perf_counter()
        pool, sel, n_rows, B = self.dataset.device_pool(device)
        self.last_sample_time = time.perf_counter() - t0
        mode = dict(self.cfg.get("train", {})).get("grid_training_mode", "coordinate+joint")
        sched = tuple(level_schedule(iterations, level_iterations,
                                     self.grid.num_levels, mode))
        masks = self._mask_cache.get(sched)
        if masks is None:
            by_level = {l: grid_net_mask(self.grid, level=l, pose=False)
                        for l in sorted(set(sched))}
            masks = [by_level[l] for l in sched]
            self._mask_cache[sched] = masks
        if self._burst_gen is None:
            self._burst_gen = torch.Generator(device=device).manual_seed(self._burst_seed)
        self.grid, tls = self._burst(self.grid, pool, sel, n_rows, self._burst_gen,
                                     masks, self.lr, int(B))
        if self.verbose:
            print(f"[mapper] burst {iterations} it loss {float(tls[-1]):.2e}", flush=True)
