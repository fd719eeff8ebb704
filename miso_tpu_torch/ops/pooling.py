"""Scatter pooling of point features onto regular grids (port of
``miso_tpu/ops/pooling.py``).

:func:`grid_pool_avg` averages per-point features per grid cell: a linear
cell id per point, then ``index_add`` of the features and of ones.  On the
card ``index_add`` accumulates with float atomics, so the order of each
cell's sum, and its last bits, change from run to run (the JAX package's
``segment_sum`` is deterministic); values agree to float32 tolerance.

Layout is channel-last ``(g0, ..., g_{d-1}, C)``, array axis k being world
axis k, as in the rest of the port.  :func:`voxel_down_sample_indices` and
:func:`crop_points` are host numpy preprocessing with data-dependent output
sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from miso_tpu_torch.ops.interp import grid_shape_for_bound


def grid_pool_avg(coords: torch.Tensor, features: torch.Tensor, bound: torch.Tensor,
                  cell_size: float, spatial=None) -> torch.Tensor:
    """Average point features per grid cell.

    Args:
      coords: (N, d) points.
      features: (N, C) per-point features.
      bound: (d, 2) grid bound.
      cell_size: nominal cell size; a point's cell is
        ``floor((x - lo) / cell_size)``, clamped to the grid per axis.
      spatial: the grid shape; from bound and cell_size when None.

    Returns (g0, ..., g_{d-1}, C) per-cell means, zero where a cell is empty;
    differentiable wrt ``features``.
    """
    d = coords.shape[-1]
    if spatial is None:
        spatial = grid_shape_for_bound(bound, cell_size, d)
    spatial = tuple(int(s) for s in spatial)
    idx = torch.floor((coords - bound[:, 0]) / cell_size).to(torch.int64)
    lin = None
    stride = 1
    for k in range(d - 1, -1, -1):
        term = idx[:, k].clamp(0, spatial[k] - 1) * stride
        lin = term if lin is None else lin + term
        stride *= spatial[k]
    C = features.shape[-1]
    sums = features.new_zeros((stride, C)).index_add(0, lin, features)
    counts = features.new_zeros((stride,)).index_add(
        0, lin, features.new_ones((coords.shape[0],)))
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return means.reshape(*spatial, C)


def voxel_down_sample_indices(points, voxel_size: float) -> np.ndarray:
    """Indices of the point closest to its voxel centre, one per occupied
    voxel (host numpy; the output size depends on the data)."""
    pts = np.asarray(points)
    grid = np.floor(pts / voxel_size).astype(np.int64)
    grid -= grid.min(axis=0)
    dims = grid.max(axis=0) + 1
    lin = (grid[:, 0] * dims[1] + grid[:, 1]) * dims[2] + grid[:, 2]
    center = (np.floor(pts / voxel_size) + 0.5) * voxel_size
    dist = np.linalg.norm(pts - center, axis=1)
    order = np.lexsort((dist, lin))
    lin_sorted = lin[order]
    first = np.ones(len(lin_sorted), dtype=bool)
    first[1:] = lin_sorted[1:] != lin_sorted[:-1]
    return order[first]


def crop_points(points, ts=None, min_z=-3.0, max_z=100.0, min_range=2.75, max_range=100.0):
    """Range and height crop of a LiDAR scan (host numpy): the points (and
    their timestamps ``ts``) with range in (min_range, max_range) and z in
    (min_z, max_z)."""
    pts = np.asarray(points)
    dist = np.linalg.norm(pts, axis=1)
    keep = (dist > min_range) & (dist < max_range) & (pts[:, 2] > min_z) & (pts[:, 2] < max_z)
    return pts[keep], (ts[keep] if ts is not None else None)
