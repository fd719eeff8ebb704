"""Dataset protocol (port of ``miso_tpu/datasets/base.py``).

Host-side numpy sampling, as in the JAX package: one "epoch" is one freshly
sampled mega-batch, and ``sample(rng) -> dict`` returns one flat dict of
fixed-shape numpy arrays.  The trainer moves each batch to the model's
device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class Dataset:
    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class SubmapDataset(Dataset):
    """The SLAM dataset API.

    Batch schema: coords_frame (N, 3) in the keyframe's frame,
    sample_frame_ids (N,) global keyframe ids, weights (N, 1); sdf,
    sdf_valid and sdf_signs (N, 1), the signs -1 occupied / 0 near the
    surface / +1 free.
    """

    @property
    def num_kfs(self) -> int:
        raise NotImplementedError

    def get_odometry_at_pose(self, src_id: int) -> np.ndarray:
        """4x4 odometry transform T_src_dst from src_id to src_id + 1."""
        raise NotImplementedError

    def sampled_points_at_kf(self, kf_id: int) -> np.ndarray:
        """(N, 3) sampled points in the keyframe's local frame."""
        raise NotImplementedError

    def select_keyframes(self, kf_ids: List[int]):
        raise NotImplementedError

    def unselect_keyframes(self):
        raise NotImplementedError

    def true_kf_pose_in_world(self, kf_id: int):
        raise NotImplementedError

    def noisy_kf_pose_in_world(self, kf_id: int):
        raise NotImplementedError
