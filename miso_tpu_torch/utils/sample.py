"""Ray sampling for the RGB-D pipelines (port of ``miso_tpu/utils/sample.py``,
host numpy as there): pixel ray directions, depth back-projection,
8-neighbour normals, pixel, stratified and along-ray depth sampling, and the
"ray", "pc" and "normal" SDF bounds.
"""
from __future__ import annotations

import numpy as np


def ray_dirs_C(H, W, fx, fy, cx, cy, depth_type="z") -> np.ndarray:
    """(H, W, 3) camera-frame ray directions (utils_sample.py:10-30).

    Camera convention: +z forward (OpenCV), pixel (r, c).
    """
    c, r = np.meshgrid(np.arange(W), np.arange(H))
    x = (c - cx) / fx
    y = (r - cy) / fy
    dirs = np.stack([x, y, np.ones_like(x)], axis=-1).astype(np.float32)
    if depth_type == "euclidean":
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs


def origin_dirs_W(T_WC, dirs_C):
    """Rotate camera-frame dirs to world (utils_sample.py:33-38).

    T_WC: (N, 4, 4); dirs_C: (N, 3).
    """
    R = T_WC[:, :3, :3]
    dirs_W = np.einsum("nij,nj->ni", R, dirs_C)
    origins = T_WC[:, :3, 3]
    return origins, dirs_W


def pointcloud_from_depth(depth, fx, fy, cx, cy, depth_type="z") -> np.ndarray:
    """(H, W) depth -> (H, W, 3) camera-frame point cloud
    (utils_sample.py:41-68).  Invalid (0/NaN) depths become NaN."""
    H, W = depth.shape
    c, r = np.meshgrid(np.arange(W), np.arange(H))
    z = np.where(np.isfinite(depth) & (depth > 0), depth, np.nan)
    x = z * (c - cx) / fx
    y = z * (r - cy) / fy
    pc = np.stack([x, y, z], axis=-1).astype(np.float32)
    if depth_type == "euclidean":
        norm = np.linalg.norm(pc, axis=-1)
        pc = pc * (z / norm)[..., None]
    return pc


def estimate_pointcloud_normals(points: np.ndarray, d: int = 2) -> np.ndarray:
    """8-neighbor normal estimation on an organized cloud
    (utils_sample.py:71-126, morefusion-derived scheme): for each pixel
    pick the neighbor pair (k, k+2) minimizing the distance sum and
    take the cross product."""
    H, W = points.shape[:2]
    pad = np.full((H + 2 * d, W + 2 * d, 3), np.nan, np.float32)
    pad[d:-d, d:-d] = points
    lookups = np.array([(-d, 0), (-d, d), (0, d), (d, d),
                        (d, 0), (d, -d), (0, -d), (-d, -d)])
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    i1, j1 = i + d, j + d
    p1 = pad[i1, j1]
    p2 = np.stack([pad[i1 + di, j1 + dj] for di, dj in lookups])      # (8, H, W, 3)
    p3 = np.stack([pad[i1 + di, j1 + dj]
                   for di, dj in lookups[(np.arange(8) + 2) % 8]])
    diff = (np.linalg.norm(p2 - p1, axis=-1)
            + np.linalg.norm(p3 - p1, axis=-1))
    diff = np.where(np.isnan(diff), np.inf, diff)
    k = np.argmin(diff, axis=0)
    p2s = np.take_along_axis(p2, k[None, ..., None], axis=0)[0]
    p3s = np.take_along_axis(p3, k[None, ..., None], axis=0)[0]
    n = np.cross(p2s - p1, p3s - p1)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    return n.astype(np.float32)


def sample_pixels(rng, n_rays, n_frames, H, W):
    """Random pixel indices per frame (utils_sample.py:129-139)."""
    total = n_rays * n_frames
    ih = rng.integers(0, H, total)
    iw = rng.integers(0, W, total)
    ib = np.repeat(np.arange(n_frames), n_rays)
    return ib, ih, iw


def stratified_sample(rng, min_depth, max_depth, n_rays, n_bins):
    """One random sample per depth bin (utils_sample.py:195-243)."""
    max_depth = np.broadcast_to(np.asarray(max_depth, np.float32), (n_rays,))
    min_depth = np.broadcast_to(np.asarray(min_depth, np.float32), (n_rays,))
    span = (max_depth - min_depth)[:, None]
    limits = np.linspace(0, 1, n_bins + 1, dtype=np.float32)[None] * span + min_depth[:, None]
    bin_len = span / n_bins
    z = limits[:, :-1] + rng.uniform(size=(n_rays, n_bins)).astype(np.float32) * bin_len
    return z.astype(np.float32)


def sample_along_rays(rng, T_WC, min_depth, max_depth, n_strat, n_surf,
                      dirs_C, gt_depth=None, surf_std=0.1):
    """Stratified + surface + near-surface depth samples per ray
    (utils_sample.py:246-302).  Returns (pc (R, S, 3) world, z_vals)."""
    origins, dirs_W = origin_dirs_W(T_WC, dirs_C)
    n_rays = len(dirs_W)
    z_vals = stratified_sample(rng, min_depth, max_depth, n_rays, n_strat)
    if gt_depth is not None and n_surf > 0:
        cols = [gt_depth[:, None]]
        if n_surf > 1:
            offs = rng.normal(0, surf_std, (n_rays, n_surf - 1)).astype(np.float32)
            near = np.clip(gt_depth[:, None] + offs,
                           np.broadcast_to(np.asarray(min_depth, np.float32), (n_rays,))[:, None],
                           np.broadcast_to(np.asarray(max_depth, np.float32), (n_rays,))[:, None])
            cols.append(near)
        z_vals = np.concatenate(cols + [z_vals], axis=1)
    pc = origins[:, None, :] + dirs_W[:, None, :] * z_vals[..., None]
    return pc.astype(np.float32), z_vals.astype(np.float32)


# -- SDF bound methods (scannet.py:663-760) ---------------------------------

def bounds_ray(depth_sample, z_vals, dirs_C_sample):
    """Along-ray distance bound, converted to euclidean."""
    bounds = depth_sample[:, None] - z_vals
    z2e = np.linalg.norm(dirs_C_sample, axis=-1)
    return (z2e[:, None] * bounds).astype(np.float32)


def bounds_pc(pc, z_vals, depth_sample):
    """Nearest-surface-sample distance bound, signed by depth order."""
    surf_pc = pc[:, 0]
    diff = pc[:, :, None] - surf_pc[None, None]
    # (R, S, R) is heavy; use per-ray own surface points only when the
    # cloud is big.  Reference computes full cross distances.
    dists = np.linalg.norm(diff, axis=-1).min(axis=-1)
    behind = z_vals > depth_sample[:, None]
    dists[behind] *= -1
    return dists.astype(np.float32)


def bounds_normal(depth_sample, z_vals, dirs_C_sample, norm_sample,
                  normal_trunc_dist):
    """Normal-corrected ray bound."""
    ray_b = bounds_ray(depth_sample, z_vals, dirs_C_sample)
    d = dirs_C_sample / np.linalg.norm(dirs_C_sample, axis=-1, keepdims=True)
    cos = np.abs(np.sum(-d * norm_sample, axis=-1))
    out = ray_b - normal_trunc_dist * (1.0 - cos)[:, None]
    trunc = ray_b < normal_trunc_dist
    out[trunc] = (ray_b * cos[:, None])[trunc]
    return out.astype(np.float32)
