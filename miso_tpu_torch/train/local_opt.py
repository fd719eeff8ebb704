"""Local optimization of one grid or an atlas (port of
``miso_tpu/train/local_opt.py``).

:func:`initialize_grid_net` sets a GridNet's features to zero, to small
random values or to the encoder's one-shot prediction;
:func:`optimize_grid_net` finetunes it coarse to fine with the iSDF loss
through ``GridTrainer``; the atlas variants do the same per submap and
jointly.  Unlike the JAX package's, these update the given grid or atlas in
place (as the port's ``GridNet`` does) and return it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from miso_tpu_torch.losses.isdf_loss import isdf_loss, isdf_loss_submap
from miso_tpu_torch.losses.miso import make_loss
from miso_tpu_torch.models.encoder import Encoder, EncoderObservation
from miso_tpu_torch.train.trainer import GridTrainer
from miso_tpu_torch.utils.profiling import synchronize


def initialize_grid_net(grid, init_mode: str = "encode", encoder: Optional[Encoder] = None,
                        encoder_observation: Optional[EncoderObservation] = None,
                        encoder_stop_level: Optional[int] = None,
                        generator: Optional[torch.Generator] = None):
    """Initialize ``grid``'s features in place: ``"zero"``; ``"randn"``
    (N(0, 1e-4^2) from ``generator``, on the grid's device; a generator seeded
    0 when None); or ``"encode"``: zero features plus the encoder's
    corrections predicted from ``encoder_observation``.  Returns (grid, info)
    with ``info['total_encoder_time']`` in seconds, the card synchronized
    before the clock is read at either end."""
    info = {"total_encoder_time": 0.0}
    if init_mode == "zero":
        return grid.zero_features(), info
    if init_mode == "randn":
        if generator is None:
            generator = torch.Generator(device=grid.bound.device).manual_seed(0)
        return grid.randn_features(generator, 1e-4), info
    if init_mode != "encode":
        raise ValueError(f"Unknown init mode: {init_mode}")
    if encoder is None or encoder_observation is None:
        raise ValueError("init_mode 'encode' needs an encoder and an encoder_observation")
    grid.zero_features()
    model_id = encoder.register_grid_model(grid)
    device = grid.bound.device
    synchronize(device)
    t0 = time.perf_counter()
    corrections = encoder.predict_corrections(model_id, encoder_observation,
                                              stop_level=encoder_stop_level)
    synchronize(device)
    info["total_encoder_time"] = time.perf_counter() - t0
    with torch.no_grad():
        for f, c in zip(grid.features, corrections):
            f.copy_(c)
    return grid, info


def _isdf_kwargs(cfg: Dict) -> Dict:
    c = cfg.get("loss", {})
    return dict(trunc_dist=c.get("trunc_distance", c.get("trunc_dist", 0.15)),
                trunc_weight=c.get("trunc_weight", 1.0))


def optimize_grid_net(grid, dataset, cfg: Dict, iterations=0, learning_rate=1e-3,
                      train_mode="joint", iterations_per_level=50, eval_tuples=(), seed=0):
    """``iterations`` GridTrainer epochs of the iSDF loss over ``dataset``
    (coarse to fine, ``iterations_per_level`` a level), in place.  Returns
    (grid, info)."""
    c = cfg.get("loss", {})
    loss_fn = make_loss(isdf_loss, **_isdf_kwargs(cfg),
                        eik_weight=c.get("eik_weight", 0.0),
                        eik_apply_dist=c.get("eik_apply_dist", 0.1))
    cfg_train = dict(cfg.get("train", {}))
    cfg_train.update({
        "max_epochs_in_level": iterations_per_level,
        "relchange_tol": 0.0,
        "grid_training_mode": train_mode,
        "epochs": iterations,
        "learning_rate": learning_rate,
        "eval_every": cfg_train.get("eval_every", -1),
    })
    trainer = GridTrainer(cfg_train, grid, loss_fn, dataset, seed=seed)
    for name, func in eval_tuples:
        trainer.register_eval_func(name, func)
    grid = trainer.train()
    info = {
        "trainer_epoch": trainer.train_dict["epochs"],
        "trainer_epoch_time": trainer.train_dict["epoch_time"],
        "trainer_total_loss": trainer.train_dict["total_loss"],
    }
    return grid, info


def initialize_grid_atlas(atlas, init_mode="encode", encoder: Optional[Encoder] = None,
                          encoder_observations: Optional[List[EncoderObservation]] = None,
                          encoder_stop_level: Optional[int] = None,
                          generator: Optional[torch.Generator] = None):
    """:func:`initialize_grid_net` on each live submap, written back into the
    atlas.  Returns (atlas, {'submap<s>': info})."""
    info = {}
    for s in range(atlas.num_submaps):
        grid = atlas.get_submap(s)
        obs = encoder_observations[s] if init_mode == "encode" else None
        grid, info[f"submap{s}"] = initialize_grid_net(grid, init_mode, encoder, obs,
                                                       encoder_stop_level, generator)
        atlas.set_submap(s, grid)
    return atlas, info


def optimize_grid_atlas(atlas, dataset, cfg: Dict, iterations=0, learning_rate=1.3e-3,
                        train_mode="coordinate", seed=0):
    """Joint refinement of the atlas's features, stability and poses (submap 0
    anchored) with the per-submap iSDF loss through ``GridTrainer``, 50
    epochs a level, in place.  Returns (atlas, {})."""
    from miso_tpu_torch.models.grid_atlas import grid_atlas_mask

    c = cfg.get("loss", {})
    loss_fn = make_loss(isdf_loss_submap, **_isdf_kwargs(cfg),
                        pose_reg_weight=c.get("pose_reg_weight", 0.0),
                        stability_weight=c.get("stability_weight", 0.0))
    cfg_train = dict(cfg.get("train", {}))
    cfg_train.update({
        "max_epochs_in_level": 50,
        "relchange_tol": 0.0,
        "grid_training_mode": train_mode,
        "epochs": iterations,
        "learning_rate": learning_rate,
    })

    def mask_for_level(params, level):
        return grid_atlas_mask(params, features=True, stability=True, submap_pose=True,
                               kf_pose=True, anchor_first_submap=True, level=level)

    params = atlas.params.requires_grad_(True)
    trainer = GridTrainer(cfg_train, params, loss_fn, dataset, mask_for_level=mask_for_level,
                          seed=seed)
    atlas.params = trainer.train().requires_grad_(False)
    return atlas, {}
