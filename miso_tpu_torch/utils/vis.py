"""Visualization utilities, headless matplotlib (port of
``miso_tpu/utils/vis.py``).  matplotlib is imported inside each function:
nothing else of the port needs it.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

# A qualitative palette, one colour a submap.
PALETTE = np.array([
    [0.12, 0.47, 0.71], [1.00, 0.50, 0.05], [0.17, 0.63, 0.17],
    [0.84, 0.15, 0.16], [0.58, 0.40, 0.74], [0.55, 0.34, 0.29],
    [0.89, 0.47, 0.76], [0.50, 0.50, 0.50], [0.74, 0.74, 0.13],
    [0.09, 0.75, 0.81],
])


def submap_color(i: int) -> np.ndarray:
    return PALETTE[i % len(PALETTE)]


def _save(fig, fig_path):
    import matplotlib.pyplot as plt

    if fig_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(fig_path)), exist_ok=True)
        fig.savefig(fig_path, bbox_inches="tight", dpi=120)
        plt.close(fig)


def visualize_sdf_plane(query_func, bound, resolution=256, axis="z",
                        fig_path=None, show_colorbar=True, show_title=True,
                        hide_axis=False, title=None):
    """A diverging-colormap slice, at a quarter of the lattice along ``axis``,
    of the SDF that ``query_func`` gives through
    ``utils/sdf.py::extract_fields`` on the query's device; returns it."""
    import matplotlib.pyplot as plt
    from matplotlib import colors

    from miso_tpu_torch.utils.sdf import extract_fields

    u = extract_fields(query_func, bound, resolution)
    idx = resolution // 4
    plane = {"x": u[idx], "y": u[:, idx], "z": u[:, :, idx]}[axis]
    vmin, vmax = float(plane.min()), float(plane.max())
    try:
        norm = colors.TwoSlopeNorm(vmin=vmin, vcenter=0.0, vmax=vmax)
    except ValueError:
        norm = colors.TwoSlopeNorm(vmin=-1, vcenter=0, vmax=1)
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(plane, cmap="seismic", norm=norm)
    ax.invert_yaxis()
    ax.invert_xaxis()
    if show_title:
        ax.set_title(title or f"SDF plane ({axis}): N={resolution}")
    if show_colorbar:
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    if hide_axis:
        ax.axis("off")
    _save(fig, fig_path)
    return plane


def _np(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def visualize_grid_scalar(grid2d, fig_path=None, cmap="viridis",
                          bounds=None, show_colorbar=True, show_title=False,
                          hide_axis=True, title=None):
    """2D scalar field heatmap."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    kw = {}
    if bounds is not None:
        kw = {"vmin": bounds[0], "vmax": bounds[1]}
    im = ax.imshow(_np(grid2d).squeeze(), cmap=cmap, **kw)
    if show_colorbar:
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    if show_title and title:
        ax.set_title(title)
    if hide_axis:
        ax.axis("off")
    _save(fig, fig_path)


def visualize_grid_magnitude(grid, fig_path=None, log_scale=True, **kw):
    """Feature-norm heatmap of a (X, Y, C) slice."""
    g = np.linalg.norm(_np(grid), axis=-1)
    if log_scale:
        g = np.log10(g + 1e-8)
    visualize_grid_scalar(g, fig_path, cmap="magma", **kw)


def plot_trajectories(trajs: Sequence[np.ndarray], labels: Sequence[str],
                      fig_path=None, title="trajectory"):
    """Top-down XY trajectory comparison: each (N, 3) positions or (N, 4, 4)
    poses."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    for t, lbl in zip(trajs, labels):
        t = _np(t)
        p = t[:, :3, 3] if t.ndim == 3 else t
        ax.plot(p[:, 0], p[:, 1], label=lbl, linewidth=1.5)
        ax.scatter(p[0, 0], p[0, 1], marker="o", s=30)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    _save(fig, fig_path)


def plot_training_curves(train_dict, keys=("total_loss",), fig_path=None,
                         yscale="log"):
    """Loss curves from a trainer's ``train_dict``."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for k in keys:
        if k in train_dict and len(train_dict[k]):
            ax.plot(train_dict["epochs"][:len(train_dict[k])], train_dict[k],
                    label=k)
    ax.set_xlabel("epoch")
    ax.set_yscale(yscale)
    ax.legend()
    _save(fig, fig_path)
