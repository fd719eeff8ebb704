"""ReplicaCAD RGB-D dataset (port of ``miso_tpu/datasets/replica.py``):
``frame_data.pt`` depth and pose batches with the camera intrinsics from the
config, sampled with :class:`PosedRgbdBase`'s ray recipe.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from miso_tpu_torch.datasets.rgbd import PosedRgbdBase


class ReplicaCAD(PosedRgbdBase):
    def __init__(self, cfg: Dict):
        d = cfg["dataset"]
        cam = d["camera"]
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        data = torch.load(os.path.join(d["path"], "frame_data.pt"),
                          map_location="cpu")
        self.depth = data["depth_batch"].numpy().astype(np.float32)
        self.T_WC_gt = data["T_WC_batch"].numpy().astype(np.float32)
        self.normals_all = (data["norm_batch"].numpy().astype(np.float32)
                            if "norm_batch" in data else None)
        self.T_WC = self.T_WC_gt.copy()
        s = cfg.get("sample", {})
        self._setup(
            n_rays=s.get("n_rays", 200),
            depth_range=tuple(s.get("depth_range", (0.07, 12.0))),
            dist_behind_surf=s.get("dist_behind_surf", 0.1),
            n_strat_samples=s.get("n_strat_samples", 19),
            n_surf_samples=s.get("n_surf_samples", 8),
            trunc_dist=cfg.get("loss", {}).get("trunc_distance", 0.15),
            bounds_method=cfg.get("loss", {}).get("bounds_method", "ray"),
        )
