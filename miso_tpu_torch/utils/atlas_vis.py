"""Atlas visualization artifacts, headless (port of
``miso_tpu/utils/atlas_vis.py``): the global mesh and an SDF plane image,
per-submap meshes in their own and the world frame, feature-norm and
stability slices, the submaps' box corners, and the frames of an alignment
animation.  Each works on the port's ``GridAtlas``; poses may be torch
tensors (on any device) or numpy arrays.  matplotlib is imported inside the
functions that draw.
"""
from __future__ import annotations

import os

import numpy as np

from miso_tpu_torch.utils.vis import _np


def visualize_atlas(atlas, save_dir: str, resolution: int = 256,
                    sdf_plane: bool = True, stability_thresh: float = 0.0):
    """The global mesh (``mesh_final.ply``) and a z slice of the SDF
    (``sdf_plane_final.png``), observed points only when
    ``stability_thresh`` > 0."""
    from miso_tpu_torch.utils.sdf import observed_sdf_query, save_mesh
    from miso_tpu_torch.utils.vis import visualize_sdf_plane

    os.makedirs(save_dir, exist_ok=True)
    query = atlas.params if stability_thresh <= 0 else \
        observed_sdf_query(atlas.params, stability_thresh)
    bound = atlas.global_bound()
    save_mesh(query, bound, os.path.join(save_dir, "mesh_final.ply"), resolution=resolution)
    if sdf_plane:
        visualize_sdf_plane(query, bound, min(resolution, 256), axis="z",
                            fig_path=os.path.join(save_dir, "sdf_plane_final.png"),
                            show_colorbar=False, show_title=False, hide_axis=True)


def render_alignment_animation(atlas, pose_frames, save_dir: str, resolution: int = 64,
                               surf_thresh: float = 0.05, max_points: int = 20000):
    """An alignment's iterations as top-down PNG frames (``frame_<i>.png``):
    each submap's near-surface cloud in its own colour, moved by that
    iteration's submap poses (``pose_frames``: one (S, 4, 4) a frame), and
    the (iterations, S, 4, 4) history beside them (``pose_history.npy``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from miso_tpu_torch.align.baselines import extract_near_surface_points

    os.makedirs(save_dir, exist_ok=True)
    S = atlas.num_submaps
    clouds = []
    for s in range(S):
        pts = extract_near_surface_points(atlas, s, resolution, surf_thresh)
        if len(pts) > max_points:
            pts = pts[np.random.default_rng(s).choice(len(pts), max_points, replace=False)]
        clouds.append(pts)
    history = np.stack([_np(T) for T in pose_frames])  # (it, S, 4, 4)
    np.save(os.path.join(save_dir, "pose_history.npy"), history)
    colors = plt.get_cmap("tab10").colors
    # Common axis limits over all frames.
    allw = np.concatenate([clouds[s] @ history[0, s, :3, :3].T + history[0, s, :3, 3]
                           for s in range(S)])
    lo, hi = allw.min(0) - 0.3, allw.max(0) + 0.3
    for it in range(len(history)):
        fig, ax = plt.subplots(figsize=(5, 5))
        for s in range(S):
            w = clouds[s] @ history[it, s, :3, :3].T + history[it, s, :3, 3]
            ax.scatter(w[:, 0], w[:, 1], s=0.2, color=colors[s % len(colors)], rasterized=True)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_aspect("equal")
        ax.set_title(f"iteration {it}")
        fig.savefig(os.path.join(save_dir, f"frame_{it:03d}.png"), dpi=110)
        plt.close(fig)


def visualize_submaps(atlas, save_dir: str, resolution: int = 128, use_pose: str = "updated"):
    """Per submap (``submap<s>/``): its mesh in its own frame and moved into
    the world by its pose (``"updated"``: with the corrections; else the
    initial one), each level's feature-norm and stability slices at the
    middle of axis 2; and every submap's box corners in the world
    (``submap_obb_corners.npy``, (S, 8, 3))."""
    from miso_tpu_torch.utils.sdf import save_mesh, write_ply
    from miso_tpu_torch.utils.vis import visualize_grid_magnitude

    p = atlas.params
    R_all, t_all = p.updated_submap_poses() if use_pose == "updated" else (p.Rws, p.tws)
    R_all, t_all = _np(R_all), _np(t_all)
    obb_rows = []
    for s in range(atlas.num_submaps):
        sub_dir = os.path.join(save_dir, f"submap{s}")
        os.makedirs(sub_dir, exist_ok=True)
        grid = atlas.get_submap(s)
        bound = _np(grid.bound)
        mesh = save_mesh(grid, bound, os.path.join(sub_dir, "mesh_submap.ply"),
                         resolution=resolution)
        R, t = R_all[s], t_all[s]
        write_ply(os.path.join(sub_dir, "mesh_submap_transformed.ply"),
                  mesh.vertices @ R.T + t, mesh.triangles)
        for level in range(grid.num_levels):
            if grid.grid_type != "regular":
                continue
            f = _np(grid.features[level])
            z = f.shape[2] // 2
            visualize_grid_magnitude(f[:, :, z, :],
                                     os.path.join(sub_dir, f"featnorm_level{level}.png"))
            mu = _np(grid.stability[level])
            visualize_grid_magnitude(mu[:, :, z, :], os.path.join(sub_dir, f"mu_level{level}.png"),
                                     log_scale=False)
        corners = np.array([[bound[0, i], bound[1, j], bound[2, k]]
                            for i in range(2) for j in range(2) for k in range(2)], np.float32)
        obb_rows.append(corners @ R.T + t)
    np.save(os.path.join(save_dir, "submap_obb_corners.npy"), np.stack(obb_rows))
