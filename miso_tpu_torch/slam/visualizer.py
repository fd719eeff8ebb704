"""Visualizer: the SLAM run's artifacts (port of
``miso_tpu/slam/visualizer.py``).

With ``visualizer.enable`` the log directory gets the trajectory so far, the
current frame's points as a PLY, and every ``mesh_vis_freq``-th update a mesh
of the atlas at ``mesh_resolution``.  The port meshes in float32
(``mesh_feature_dtype`` is not read: bf16 feature storage is not ported), and
the live browser view (``visualizer.live``) waits for ``slam/live_viewer.py``
(ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from miso_tpu_torch.models.grid_atlas import GridAtlas
from miso_tpu_torch.utils.sdf import save_mesh, write_ply


class Visualizer:
    def __init__(self, model: GridAtlas, cfg: Dict):
        self.atlas = model
        c = cfg.get("visualizer", {})
        self.enable = bool(c.get("enable", False))
        self.mesh_vis_freq = int(c.get("mesh_vis_freq", 10))
        self.mesh_resolution = int(c.get("mesh_resolution", 128))
        self.show_mesh = bool(c.get("show_mesh", True))
        self.log_dir = cfg.get("system", {}).get("log_dir", "./results/default")
        self._frame_points: Optional[np.ndarray] = None
        self._count = 0
        if self.enable and c.get("live", False):
            raise NotImplementedError("visualizer.live: slam/live_viewer.py is not "
                                      "ported yet (ROADMAP Queue 1, item 8)")
        if self.enable:
            os.makedirs(self.log_dir, exist_ok=True)

    def set_current_frame_points(self, points: np.ndarray):
        self._frame_points = np.asarray(points)

    def update_geometries(self, stop_frame: int):
        if not self.enable:
            return
        self._count += 1
        _, t = self.atlas.params.updated_kf_poses_in_world()
        np.savetxt(os.path.join(self.log_dir, "trajectory_live.txt"),
                   t[:stop_frame].detach().cpu().numpy())
        if self._frame_points is not None and len(self._frame_points):
            write_ply(os.path.join(self.log_dir, "current_frame.ply"),
                      self._frame_points, np.zeros((0, 3), np.int32))
        if self.show_mesh and self._count % self.mesh_vis_freq == 0:
            try:
                save_mesh(self.atlas.params, self.atlas.global_bound(),
                          os.path.join(self.log_dir, f"mesh_frame{stop_frame:05d}.ply"),
                          resolution=self.mesh_resolution)
            except Exception as e:  # meshing must never kill SLAM
                print(f"[visualizer] mesh export failed: {e}")

    def quit(self):
        pass

    def update_view(self):
        pass
