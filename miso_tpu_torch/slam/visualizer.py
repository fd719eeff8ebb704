"""Visualizer: the SLAM run's artifacts and its live view (port of
``miso_tpu/slam/visualizer.py``).

With ``visualizer.enable`` the log directory gets the trajectory so far, the
current frame's points as a PLY, and every ``mesh_vis_freq``-th update a mesh
of the atlas at ``mesh_resolution``, queried with its feature storage cast to
``mesh_feature_dtype`` (bfloat16 by default, as in the JAX package; null for
float32; ``utils/sdf.py::cast_feature_storage``).  With ``visualizer.live``
the run also serves a live browser view on ``live_port``
(``slam/live_viewer.py``): the trajectory, the frame's points, the submap
boxes and the latest mesh.
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
        self.mesh_dtype = c.get("mesh_feature_dtype", "bfloat16")
        self.show_mesh = bool(c.get("show_mesh", True))
        self.log_dir = cfg.get("system", {}).get("log_dir", "./results/default")
        self._frame_points: Optional[np.ndarray] = None
        self._count = 0
        self.live = None
        if self.enable:
            os.makedirs(self.log_dir, exist_ok=True)
            if c.get("live", False):
                from miso_tpu_torch.slam.live_viewer import LiveViewer

                self.live = LiveViewer(port=int(c.get("live_port", 8800)))
                print(f"[visualizer] live view at http://127.0.0.1:{self.live.port}/")

    def set_current_frame_points(self, points: np.ndarray):
        self._frame_points = np.asarray(points)

    def update_geometries(self, stop_frame: int):
        if not self.enable:
            return
        self._count += 1
        _, t = self.atlas.params.updated_kf_poses_in_world()
        traj = t[:stop_frame].detach().cpu().numpy()
        np.savetxt(os.path.join(self.log_dir, "trajectory_live.txt"), traj)
        if self._frame_points is not None and len(self._frame_points):
            write_ply(os.path.join(self.log_dir, "current_frame.ply"),
                      self._frame_points, np.zeros((0, 3), np.int32))
        mesh = None
        if self.show_mesh and self._count % self.mesh_vis_freq == 0:
            try:
                mesh = save_mesh(self.atlas.params, self.atlas.global_bound(),
                                 os.path.join(self.log_dir, f"mesh_frame{stop_frame:05d}.ply"),
                                 resolution=self.mesh_resolution,
                                 feature_dtype=self.mesh_dtype)
            except Exception as e:  # meshing must never kill SLAM
                print(f"[visualizer] mesh export failed: {e}")
        if self.live is not None:
            from miso_tpu_torch.slam.live_viewer import submap_box_corners

            p = self.atlas.params
            Rs, ts = (v.detach().cpu().numpy() for v in p.updated_submap_poses())
            bounds = p.bounds.detach().cpu().numpy()
            boxes = [submap_box_corners(bounds[s], Rs[s], ts[s])
                     for s in range(self.atlas.num_submaps)]
            self.live.update(frame=stop_frame, traj_est=traj, frame_points=self._frame_points,
                             submap_boxes=boxes, num_submaps=self.atlas.num_submaps,
                             mesh=None if mesh is None else (mesh.vertices, mesh.triangles))

    def quit(self):
        if self.live is not None:
            self.live.close()

    def update_view(self):
        pass
