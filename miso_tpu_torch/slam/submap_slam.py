"""Online SLAM in one submap: the per-frame loop of
``miso_tpu/slam/system.py::System`` for a run that never spawns a second
submap (``System.run`` with ``submap_size`` at least the sequence's length
and ``submap_fov_thresh`` 0).

The submap's frame is the world pose of keyframe 0 (R_world_origin,
t_world_origin); keyframe 0 sits at the identity in it, and the grid's bound
is ``system.submap_local_bound`` in that frame.  Start-up maps keyframe 0
into ``max_replay_frames + 1`` slots for ``mapping.init_iterations``
iterations.  Then, per frame:

  1. odometry: the next keyframe's initial pose is the previous one's
     corrected pose composed with the dataset's odometry;
  2. ``Tracker.track`` of that keyframe (LM or Adam);
  3. a mapping burst of ``mapping.iters_per_frame`` iterations over the
     replay window (every ``replay_freq``-th keyframe since the submap's
     first, and the head), padded to ``max_replay_frames + 1`` slots by
     repeating the window, as the JAX system pads it.

With ``system.profile`` true each stage is timed on the host clock after a
``torch.cuda.synchronize()`` (on a CUDA grid), in ``stage_ms``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from miso_tpu_torch.models.grid_net import GridNet
from miso_tpu_torch.ops import se3
from miso_tpu_torch.slam.mapper import Mapper
from miso_tpu_torch.slam.tracker import Tracker


def replay_window(first_kf: int, head_kf: int, max_replay_frames: int,
                  max_replay_freq: int):
    """The keyframes one mapping burst replays, padded to
    ``max_replay_frames + 1`` slots."""
    replay_freq = max((head_kf - first_kf) // max_replay_frames, max_replay_freq)
    kfs = list(range(first_kf, head_kf, replay_freq)) + [head_kf]
    slots = max_replay_frames + 1
    if len(kfs) > slots:
        kfs = kfs[-slots:]
    base = list(kfs)
    while len(kfs) < slots:
        kfs.append(base[len(kfs) % len(base)])
    return kfs


class SubmapSlam:
    """Tracks and maps a dataset's keyframes into one submap GridNet.

    ``grid`` is the submap's model in its own frame (built by the caller,
    e.g. ``create_grid_net(cfg['model'], bound=cfg['system']
    ['submap_local_bound'], num_poses=...)``, on the card by default); it is
    trained in place.  Start-up mapping runs in the constructor.
    """

    def __init__(self, grid: GridNet, dataset_track, dataset_map, cfg: Dict,
                 R_world_origin=None, t_world_origin=None):
        self.grid = grid
        self.cfg = cfg
        self.dataset_track = dataset_track
        self.dataset_map = dataset_map
        m = cfg["mapping"]
        self.max_replay_frames = m.get("max_replay_frames", 10)
        self.max_replay_freq = m.get("max_replay_freq", 10)
        self.map_iters = m.get("iters_per_frame", 15)
        self.map_level_iters = m.get("level_iters_per_frame", 5)
        self.init_iters = m.get("init_iterations", 50)
        s = cfg.get("system", {})
        if s.get("init_odom", "external") not in ("external", "static"):
            raise ValueError(f"Unknown odometry type: {s.get('init_odom')}")
        self.init_odom = s.get("init_odom", "external")
        self.profile = bool(s.get("profile", False))
        self.R_ws = np.eye(3, dtype=np.float32) if R_world_origin is None \
            else np.asarray(R_world_origin, np.float32)
        self.t_ws = np.zeros(3, np.float32) if t_world_origin is None \
            else np.asarray(t_world_origin, np.float32).reshape(3)
        self.curr_kf = 0
        self.first_frame_in_submap = 0
        self.stage_ms: Dict[str, list] = {"track": [], "map": []}
        self.tracker = Tracker(grid, dataset_track, cfg)
        self.mapper = Mapper(grid, dataset_map, cfg)
        self.mapper.mapping([0] * (self.max_replay_frames + 1),
                            iterations=self.init_iters,
                            level_iterations=max(self.init_iters // 3, 1))

    @property
    def num_keyframes(self) -> int:
        return self.curr_kf + 1

    def _sync(self):
        if self.grid.bound.is_cuda:
            torch.cuda.synchronize(self.grid.bound.device)

    def _timed(self, name, fn):
        if not self.profile:
            fn()
            return
        self._sync()
        t0 = time.perf_counter()
        fn()
        self._sync()
        self.stage_ms[name].append(1e3 * (time.perf_counter() - t0))

    def initialize_next_kf(self):
        """The next keyframe's initial pose from odometry."""
        dst = self.curr_kf + 1
        R_src, t_src = self.grid.updated_kf_pose(dst - 1)
        T_ss = se3.pose_matrix(R_src, t_src).cpu().numpy()
        T_sd = (np.asarray(self.dataset_track.get_odometry_at_pose(dst - 1))
                if self.init_odom == "external" else np.eye(4, dtype=np.float32))
        T = T_ss @ T_sd
        self.grid.set_initial_kf_pose(dst, T[:3, :3], T[:3, 3])
        self.curr_kf = dst

    def step(self):
        """One frame: odometry, tracking, mapping."""
        self.initialize_next_kf()
        head = self.curr_kf
        self._timed("track", lambda: self.tracker.track(optimize_kf=head))
        kfs = replay_window(self.first_frame_in_submap, head, self.max_replay_frames,
                            self.max_replay_freq)
        self._timed("map", lambda: self.mapper.mapping(
            kfs, iterations=self.map_iters, level_iterations=self.map_level_iters))

    def run(self, max_frames: Optional[int] = None):
        stop = self.dataset_map.num_kfs if max_frames is None \
            else min(self.dataset_map.num_kfs, max_frames)
        if stop > self.grid.num_poses:
            raise ValueError(f"{stop} keyframes do not fit the grid's "
                             f"{self.grid.num_poses} pose rows")
        while self.num_keyframes < stop:
            self.step()
        return self

    @torch.no_grad()
    def kf_poses_in_world(self):
        """World poses (R (n, 3, 3), t (n, 3)) of the keyframes so far, as
        numpy arrays."""
        R, t = self.grid.updated_kf_poses()
        n = self.num_keyframes
        Rw, tw = se3.transform_poses_to(R[:n], t[:n],
                                        torch.as_tensor(self.R_ws, device=R.device),
                                        torch.as_tensor(self.t_ws, device=R.device))
        return Rw.cpu().numpy(), tw.cpu().numpy()
