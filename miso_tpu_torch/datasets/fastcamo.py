"""FastCaMo RGB-D dataset (port of ``miso_tpu/datasets/fastcamo.py``): the
ReplicaCAD layout, with optional simulated rotation and translation noise on
the initial pose estimates (first frame anchored).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from miso_tpu_torch.datasets.rgbd import PosedRgbdBase


class FastCaMo(PosedRgbdBase):
    def __init__(self, cfg: Dict):
        from scipy.spatial.transform import Rotation

        d = cfg["dataset"]
        cam = d.get("camera", {})
        self.fx = float(cam.get("fx", 600.0))
        self.fy = float(cam.get("fy", 600.0))
        self.cx = float(cam.get("cx", 599.5))
        self.cy = float(cam.get("cy", 339.5))
        data = torch.load(os.path.join(d["path"], "frame_data.pt"),
                          map_location="cpu")
        self.depth = data["depth_batch"].numpy().astype(np.float32)
        self.T_WC_gt = data["T_WC_batch"].numpy().astype(np.float32)
        self.normals_all = (data["norm_batch"].numpy().astype(np.float32)
                            if "norm_batch" in data else None)
        # Pose noise injection (fastcamo.py noisy-pose options).
        std_rad = float(d.get("pose_noise_rad", 0.0))
        std_m = float(d.get("pose_noise_meter", 0.0))
        rng = np.random.default_rng(int(d.get("pose_noise_seed", 0)))
        n = len(self.T_WC_gt)
        Rn = Rotation.from_rotvec(rng.standard_normal((n, 3)) * std_rad).as_matrix()
        tn = rng.standard_normal((n, 3)) * std_m
        Rn[0] = np.eye(3)
        tn[0] = 0
        T = self.T_WC_gt.copy()
        T[:, :3, :3] = np.einsum("nij,njk->nik", T[:, :3, :3], Rn)
        T[:, :3, 3] += tn
        self.T_WC = T.astype(np.float32)
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
