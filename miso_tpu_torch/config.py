"""Config loading and the factory registries (port of ``miso_tpu/config.py``).

YAML with recursive ``inherit_from`` and a deep merge over an optional
default file; registries map the names in ``configs/*.yaml`` to model, loss
and dataset constructors, and ``cfg_*`` build them.  Models are built on
``device`` ("cuda" unless the caller asks for the CPU), their random draws
from ``generator`` (seeded from the config's ``seed`` when None).

An entry whose class is not ported yet raises ``NotImplementedError`` naming
the ROADMAP item (Queue 1) that ports it.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import yaml


def update_recursive(dict1: Dict, dict2: Dict):
    """Deep-merge dict2 into dict1."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: str, default_path: Optional[str] = None) -> Dict:
    """Load a YAML config, following ``inherit_from`` (relative to the file,
    else as given) recursively, or over ``default_path``."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f)
    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        if not os.path.isabs(inherit_from):
            cand = os.path.join(os.path.dirname(path), inherit_from)
            inherit_from = cand if os.path.exists(cand) else inherit_from
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f)
    else:
        cfg = {}
    update_recursive(cfg, cfg_special)
    return cfg


def save_config(cfg: Dict, path: str):
    """Write a snapshot of the config as YAML."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_yaml_safe(cfg), f)


def _yaml_safe(x):
    import numpy as np

    if isinstance(x, dict):
        return {k: _yaml_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_yaml_safe(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


# ---------------------------------------------------------------------------
# Registries.
# ---------------------------------------------------------------------------

MODEL_REGISTRY: Dict[str, Callable] = {}
LOSS_REGISTRY: Dict[str, Callable] = {}
DATASET_REGISTRY: Dict[str, Callable] = {}


def register_model(name):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco


def register_loss(name):
    def deco(fn):
        LOSS_REGISTRY[name] = fn
        return fn
    return deco


def register_dataset(name):
    def deco(fn):
        DATASET_REGISTRY[name] = fn
        return fn
    return deco


def _lookup(registry, kind, name):
    if name not in registry:
        _register_builtins()
    if name not in registry:
        raise ValueError(f"Unknown {kind}: {name}")
    return registry[name]


def cfg_model(cfg: Dict, generator=None, device="cuda", **kwargs):
    """Build the model named in cfg['model']['name'] on ``device``."""
    import torch

    fn = _lookup(MODEL_REGISTRY, "model", cfg["model"]["name"])
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return fn(cfg, generator, device, **kwargs)


def cfg_loss(cfg: Dict, **kwargs):
    """Build the loss named in cfg['loss']['name']: a (model, batch, key) ->
    dict callable."""
    return _lookup(LOSS_REGISTRY, "loss", cfg["loss"]["name"])(cfg, **kwargs)


def cfg_dataset(cfg: Dict, **kwargs):
    """Build the dataset named in cfg['dataset']['name'] (host-side numpy
    sampling of fixed-shape batches)."""
    return _lookup(DATASET_REGISTRY, "dataset", cfg["dataset"]["name"])(cfg, **kwargs)


def cfg_trainer(cfg: Dict, model, loss_fn, dataset, val_dataset=None, **kwargs):
    """Build the base or grid trainer of cfg['train'] and write a snapshot of
    the config to its log_dir."""
    from miso_tpu_torch.train.trainer import GridTrainer, Trainer

    cfg_train = cfg["train"]
    log_dir = cfg_train.get("log_dir")
    if log_dir:
        save_config(cfg, os.path.join(log_dir, "cfg.yaml"))
    cls = GridTrainer if cfg_train.get("trainer", "base") == "grid" else Trainer
    return cls(cfg_train, model, loss_fn, dataset, val_dataset, **kwargs)


def _not_ported(what: str, item: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item})")
    return build


_BUILTINS_DONE = False


def _register_builtins():
    global _BUILTINS_DONE
    if _BUILTINS_DONE:
        return
    _BUILTINS_DONE = True

    from miso_tpu_torch.losses.fusion import fusion_loss, posed_sdf_loss_3d_submap
    from miso_tpu_torch.losses.isdf_loss import isdf_loss, isdf_loss_submap
    from miso_tpu_torch.losses.miso import (make_loss, mapping_loss, posed_sdf_loss_3d,
                                            tracking_loss)
    from miso_tpu_torch.losses.sdf import sdf_loss_3d, tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net

    # -- models ------------------------------------------------------------
    @register_model("grid_net")
    def _grid_net(cfg, generator, device, **kw):
        return create_grid_net(cfg["model"], generator=generator, device=device, **kw)

    @register_model("grid_atlas")
    def _grid_atlas(cfg, generator, device, **kw):
        from miso_tpu_torch.models.grid_atlas import GridAtlas
        sys_cfg = cfg.get("system", {})
        return GridAtlas(cfg["model"], max_kfs_per_submap=sys_cfg.get("submap_size", 1),
                         capacity=sys_cfg.get("submap_capacity"), device=device)

    for name, what in (("isdf", "iSDF"), ("pointsdf", "PointSDF"), ("ngp", "HashGrid")):
        MODEL_REGISTRY[name] = _not_ported(what, "item 6 (alternative models and grids)")

    # -- losses ------------------------------------------------------------
    def _kw(cfg, keys):
        c = cfg["loss"]
        return {k: c[k] for k in keys if k in c}

    @register_loss("Sdf3D")
    def _sdf3d(cfg):
        return make_loss(sdf_loss_3d, **_kw(cfg, ["sdf_weight"]))

    @register_loss("Tsdf3D")
    def _tsdf3d(cfg):
        return make_loss(tsdf_loss_3d, **_kw(cfg, [
            "sdf_weight", "sign_weight", "eik_weight", "trunc_dist",
            "grad_method", "finite_diff_eps"]))

    @register_loss("MisoTracking")
    def _tracking(cfg):
        c = cfg.get("tracking", cfg.get("loss", {}))
        return make_loss(tracking_loss, loss_type=c.get("loss_type", "L2"),
                         trunc_dist=c.get("trunc_dist"),
                         gm_scale_sdf=c.get("gm_scale_sdf", 1.0))

    @register_loss("MisoMapping")
    def _mapping(cfg):
        c = cfg.get("mapping", cfg.get("loss", {}))
        return make_loss(mapping_loss, loss_type=c.get("loss_type", "L1"),
                         weight_sdf=c.get("weight_sdf", 1.0),
                         weight_eik=c.get("weight_eik", 0.0),
                         weight_fs=c.get("weight_fs", 0.0),
                         trunc_dist=c.get("trunc_dist", 0.15),
                         finite_diff_eps=c.get("finite_diff_eps", 1e-2),
                         grad_method=c.get("grad_method", "finitediff"),
                         eik_trunc_dist=c.get("eik_trunc_dist", 0.1))

    LOSS_REGISTRY["Sdf2D"] = _not_ported("The Sdf2D loss", "item 6 (2D grids)")
    @register_loss("PosedSdf3DSubmap")
    def _posed_submap(cfg):
        c = cfg["loss"]
        return make_loss(posed_sdf_loss_3d_submap,
                         sdf_weight=c.get("sdf_weight", 3e3),
                         sign_weight=c.get("sign_weight", 1e2),
                         smooth_weight=c.get("smooth_weight", 0.0),
                         smooth_std=c.get("smooth_std", 0.1),
                         trunc_dist=c.get("trunc_dist", 0.15),
                         grad_method=c.get("grad_method", "finitediff"),
                         finite_diff_eps=c.get("finite_diff_eps", 1e-2),
                         loss_type=c.get("type", "L2"),
                         pose_reg_weight=c.get("pose_reg_weight", 0.0))

    @register_loss("MisoFusion")
    def _fusion(cfg):
        c = cfg.get("mapping", cfg.get("loss", {}))
        return make_loss(fusion_loss, loss_type=c.get("loss_type", "L1"),
                         weight_sdf=c.get("weight_sdf", 1.0),
                         weight_eik=c.get("weight_eik", 0.0),
                         weight_fs=c.get("weight_fs", 0.0),
                         trunc_dist=c.get("trunc_dist", 0.15),
                         finite_diff_eps=c.get("finite_diff_eps", 1e-2),
                         grad_method=c.get("grad_method", "finitediff"),
                         eik_trunc_dist=c.get("eik_trunc_dist", 0.1))

    @register_loss("PosedSdf3D")
    def _posed(cfg):
        return make_loss(posed_sdf_loss_3d, **_kw(cfg, [
            "sdf_weight", "sign_weight", "eik_weight", "smooth_weight",
            "trunc_dist", "smooth_std", "grad_method", "finite_diff_eps"]))

    @register_loss("iSDF")
    def _isdf_loss(cfg):
        c = cfg["loss"]
        return make_loss(isdf_loss,
                         trunc_dist=c.get("trunc_dist", 0.15),
                         sdf_weight=c.get("sdf_weight", 1.0),
                         grad_weight=c.get("grad_weight", 0.0),
                         eik_weight=c.get("eik_weight", 0.0),
                         eik_apply_dist=c.get("eik_apply_dist", 0.1),
                         free_space_factor=c.get("free_space_factor", 5.0))

    @register_loss("iSDFSubmap")
    def _isdf_submap(cfg):
        c = cfg["loss"]
        return make_loss(isdf_loss_submap,
                         trunc_dist=c.get("trunc_dist", 0.15),
                         sdf_weight=c.get("sdf_weight", 1.0),
                         eik_weight=c.get("eik_weight", 0.0),
                         eik_apply_dist=c.get("eik_apply_dist", 0.1),
                         free_space_factor=c.get("free_space_factor", 5.0),
                         pose_reg_weight=c.get("pose_reg_weight", 0.0),
                         stability_weight=c.get("stability_weight", 0.0))

    # -- datasets ----------------------------------------------------------
    @register_dataset("Sdf3D")
    def _d_sdf3d(cfg):
        from miso_tpu_torch.datasets.sdf_3d import Sdf3D
        d = cfg["dataset"]
        return Sdf3D(d["path"], batch_size=cfg["train"].get("batch_size", 2**16),
                     trunc_dist=d.get("trunc_dist"))

    @register_dataset("PosedSdf3D")
    def _d_posed(cfg):
        from miso_tpu_torch.datasets.sdf_3d import PosedSdf3D
        d = cfg["dataset"]
        return PosedSdf3D(d["path"],
                          frame_batchsize=d.get("frame_batchsize", 2**14),
                          frame_samples=d.get("frame_samples", 2**14),
                          num_frames=d.get("num_frames", 64),
                          trunc_dist=d.get("trunc_dist", 0.15))

    DATASET_REGISTRY["Sdf2D"] = _not_ported("Sdf2D", "item 6 (2D grids)")
    for name in ("PosedSdf3DLidar", "ScanNet", "ReplicaCAD", "FastCaMo"):
        DATASET_REGISTRY[name] = _not_ported(f"The {name} dataset", "item 2")
