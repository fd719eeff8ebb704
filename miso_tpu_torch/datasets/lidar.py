"""KITTI-format pose files (port of ``miso_tpu/datasets/lidar.py``'s
``read_kitti_format_poses`` and ``write_kitti_format_poses``).  The LiDAR
dataset itself (``PosedSdf3DLidar``) is not ported yet (ROADMAP Queue 1,
item 2)."""
from __future__ import annotations

from typing import List

import numpy as np


def read_kitti_format_poses(path: str) -> List[np.ndarray]:
    """A file of 3x4 pose rows -> list of 4x4 matrices."""
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.strip().split()]
            if len(vals) < 12:
                raise ValueError("Not a KITTI-format pose file")
            T = np.eye(4)
            T[:3, :4] = np.asarray(vals[:12]).reshape(3, 4)
            poses.append(T)
    return poses


def write_kitti_format_poses(path: str, poses: np.ndarray):
    """(N, 4, 4) -> one row of the 3x4 top per pose."""
    flat = np.asarray(poses)[:, :3, :].reshape(len(poses), -1)
    np.savetxt(path, flat)
