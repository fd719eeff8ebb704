"""ScanNet scene metadata and dataset factory (port of
``miso_tpu/utils/scannet_meta.py``): the four benchmark scenes' bounds and
anchor keyframes, a ``ScanNet`` factory, and a mesh's ICP alignment to the
ground-truth mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SceneMetadata:
    bound: list
    name: str
    path: str
    intrinsics_file: str
    gt_mesh: str
    num_kfs: int
    anchor_kfs: list


def scannet_scenes(data_root: str = "./data/ScanNet") -> Dict[str, SceneMetadata]:
    """The four benchmark scenes (bounds/anchors from the reference)."""
    def scene(name, bound, num_kfs, anchor_kfs):
        return SceneMetadata(
            name=name,
            path=f"{data_root}/scene{name}_mipsfusion",
            intrinsics_file=f"{data_root}/scene{name}_mipsfusion/scene{name}.txt",
            gt_mesh=f"{data_root}/scans/scene{name}/scene{name}_vh_clean.ply",
            bound=bound, num_kfs=num_kfs, anchor_kfs=anchor_kfs)

    return {
        "0000_00": scene("0000_00", [[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]],
                         372, [0, 124, 255]),
        "0011_00": scene("0011_00", [[1.50, 7.50], [-0.05, 8.25], [-0.05, 2.70]],
                         159, [0, 73, 86, 121]),
        "0024_00": scene("0024_00", [[0.00, 7.20], [-0.05, 8.05], [-0.05, 2.50]],
                         227, [0, 30, 84, 101, 131]),
        "0207_00": scene("0207_00", [[1.00, 9.00], [0.00, 7.10], [-0.10, 2.90]],
                         133, [0, 35]),
    }


def create_scannet_dataset(cfg: Dict, scene: SceneMetadata):
    """The ScanNet dataset of ``scene`` from ``cfg``."""
    import copy

    from miso_tpu_torch.datasets.scannet import ScanNet

    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["path"] = scene.path
    cfg["dataset"]["intrinsics_file"] = scene.intrinsics_file
    cfg["dataset"]["anchor_kfs"] = scene.anchor_kfs
    cfg["model"]["grid"]["bound"] = scene.bound
    cfg["model"]["pose"]["num_poses"] = scene.num_kfs
    return ScanNet(cfg)


def align_mesh_to_gt(est_mesh, gt_mesh, n_points=200000,
                     max_corr_coarse=0.75, max_corr_fine=0.1, seed=0):
    """ICP-align a reconstructed mesh to the GT mesh (coarse then fine
    point-to-point); returns (the 4x4 transform, rmse, fitness)."""
    from miso_tpu_torch.utils.eval import icp_point_to_point

    src = est_mesh.sample_surface(n_points, seed=seed)
    dst = gt_mesh.sample_surface(n_points, seed=seed + 1)
    T1, _, _ = icp_point_to_point(src, dst, max_corr_dist=max_corr_coarse)
    src2 = src @ T1[:3, :3].T + T1[:3, 3]
    T2, rmse, fitness = icp_point_to_point(src2, dst, max_corr_dist=max_corr_fine)
    return (T2 @ T1).astype(np.float32), rmse, fitness
