"""Preprocessed ScanNet dataset (port of ``miso_tpu/datasets/scannet.py``).

Reads ``frame_data.pt`` (depth, pose and normal batches), the ICP odometry
``cam_poses_icp.npy`` when present (the initial pose estimates), and the
optional submap boxes and keyframe association ``submaps.pt``; samples with
:class:`PosedRgbdBase`'s ray recipe.  ``simulate_noisy_poses`` perturbs the
initial estimates.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from miso_tpu_torch.datasets.rgbd import PosedRgbdBase


def load_scannet_intrinsics(path: str):
    """ScanNet info txt: fx/fy/cx/cy + depth image size."""
    vals = {}
    with open(path) as f:
        for line in f:
            if "=" in line:
                k, v = line.split("=", 1)
                vals[k.strip()] = v.strip()
    fx = float(vals.get("fx_depth", vals.get("fx", 577.0)))
    fy = float(vals.get("fy_depth", vals.get("fy", 577.0)))
    cx = float(vals.get("mx_depth", vals.get("cx", 319.5)))
    cy = float(vals.get("my_depth", vals.get("cy", 239.5)))
    W = int(float(vals.get("depthWidth", 640)))
    H = int(float(vals.get("depthHeight", 480)))
    return fx, fy, cx, cy, H, W


class ScanNet(PosedRgbdBase):
    def __init__(self, cfg: Dict):
        d = cfg["dataset"]
        root = d["path"]
        data = torch.load(os.path.join(root, "frame_data.pt"), map_location="cpu")
        self.depth = data["depth_batch"].numpy().astype(np.float32)
        self.T_WC_gt = data["T_WC_batch"].numpy().astype(np.float32)
        self.normals_all = (data["norm_batch"].numpy().astype(np.float32)
                            if "norm_batch" in data else None)
        icp = os.path.join(root, "cam_poses_icp.npy")
        if os.path.exists(icp):
            self.T_WC_odom = np.load(icp).astype(np.float32)
        else:
            self.T_WC_odom = self.T_WC_gt.copy()
        self.T_WC = self.T_WC_odom  # init estimates come from ICP odometry
        intr = d.get("intrinsics_file")
        if intr and os.path.exists(intr):
            self.fx, self.fy, self.cx, self.cy, _, _ = load_scannet_intrinsics(intr)
        else:
            H, W = self.depth.shape[1:]
            self.fx = self.fy = 577.87
            self.cx, self.cy = (W - 1) / 2.0, (H - 1) / 2.0
        # Precomputed submap structure (scannet.py:79-93).
        sub_file = os.path.join(root, "submaps.pt")
        self.submaps = None
        self.keyframe_to_submap = None
        self.anchor_kfs = d.get("anchor_kfs")
        if os.path.exists(sub_file):
            sub = torch.load(sub_file, map_location="cpu")
            self.submaps = sub["submaps"].numpy()  # (M, 6) center + extents
            assoc = sub["kframe_submap_assoc"].numpy()
            self.keyframe_to_submap = assoc[:, 0].tolist()
        s = cfg.get("sample", {})
        self._setup(
            n_rays=s.get("n_rays", 200),
            depth_range=tuple(s.get("depth_range", (0.07, 12.0))),
            dist_behind_surf=s.get("dist_behind_surf", 0.1),
            n_strat_samples=s.get("n_strat_samples", 19),
            n_surf_samples=s.get("n_surf_samples", 8),
            trunc_dist=d.get("trunc_dist", 0.15),
            bounds_method=d.get("bounds_method", "ray"),
        )
        # Optional CLIP supervision (reference sdf_rgbd.py:295-380).
        if d.get("clip_features"):
            self.load_clip_features(d["clip_features"],
                                    n_clip_rays=s.get("n_clip_rays"))

    def submap_bound(self, submap_id: int, buffer=0.5) -> np.ndarray:
        """(3, 2) local bound of a precomputed submap box."""
        c = self.submaps[submap_id, :3]
        e = self.submaps[submap_id, 3:] / 2.0 + buffer
        return np.stack([-e, e], axis=1).astype(np.float32)

    def simulate_noisy_poses(self, rng, std_rad=0.0, std_meter=0.0, anchor=0):
        """Perturb init poses (scannet.py:186-279 noisy-pose utilities)."""
        from scipy.spatial.transform import Rotation

        n = self.num_kfs
        Rn = Rotation.from_rotvec(rng.standard_normal((n, 3)) * std_rad).as_matrix()
        tn = rng.standard_normal((n, 3)) * std_meter
        Rn[anchor] = np.eye(3)
        tn[anchor] = 0
        T = self.T_WC_gt.copy()
        T[:, :3, :3] = np.einsum("nij,njk->nik", T[:, :3, :3], Rn)
        T[:, :3, 3] += tn
        self.T_WC = T.astype(np.float32)
