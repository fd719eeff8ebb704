"""Synthetic mesh-based SDF dataset (port of ``miso_tpu/datasets/sdf_3d.py``:
``Sdf3D``).

The native BVH runtime (``miso_tpu_torch/native``) gives the signed distance
(positive outside).  Sampling is numpy from a seed, so the same mesh and seed
give the JAX package's batches exactly.  ``PosedSdf3D`` and the ``Batched*``
wrappers wait for the SLAM slice.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

from miso_tpu_torch.datasets.base import Dataset
from miso_tpu_torch.native import TriangleMesh

MeshLike = Union[str, TriangleMesh, Tuple[np.ndarray, np.ndarray]]


def as_mesh(mesh: MeshLike) -> TriangleMesh:
    if isinstance(mesh, TriangleMesh):
        return mesh
    if isinstance(mesh, str):
        from miso_tpu_torch.utils.sdf import read_ply
        return TriangleMesh(*read_ply(mesh))
    verts, tris = mesh
    return TriangleMesh(verts, tris)


class Sdf3D(Dataset):
    """GT-SDF dataset from a watertight mesh.

    Sampling: 7/8 surface points (the second half perturbed by
    ``surface_stddev``), 1/8 uniform in the (buffered) bound.  Exact surface
    samples get sdf label 0.
    """

    def __init__(self, mesh: MeshLike, batch_size=2**16, total_samples=2**20,
                 surface_stddev=0.1, bound_buffer=0.5, trunc_dist=None, seed=0):
        self.mesh = as_mesh(mesh)
        v = self.mesh.vertices
        self.bound = np.stack([v.min(0) - bound_buffer, v.max(0) + bound_buffer], axis=1)
        self.surface_stddev = surface_stddev
        self.total_samples = int(total_samples)
        self.batch_size = int(batch_size)
        self.trunc_dist = trunc_dist
        if self.total_samples % 8:
            raise ValueError(f"total_samples {self.total_samples} is not a multiple of 8")
        self._rng = np.random.default_rng(seed)
        self.resample()

    def resample(self):
        n = self.total_samples
        rng = self._rng
        pts_surf = self.mesh.sample_surface(n * 7 // 8, seed=int(rng.integers(2**31)))
        perturb_lo = n // 2
        pts_surf[perturb_lo:] += (self.surface_stddev * rng.standard_normal(
            (n * 7 // 8 - perturb_lo, 3))).astype(np.float32)
        u = rng.uniform(size=(n // 8, 3))
        pts_unif = (self.bound[:, 0] + u * (self.bound[:, 1] - self.bound[:, 0])
                    ).astype(np.float32)
        points = np.concatenate([pts_surf, pts_unif]).astype(np.float32)
        sdfs = np.zeros((n, 1), np.float32)
        sdfs[n // 2:] = self.mesh.signed_distance(points[n // 2:])[:, None]
        sdf_valid = (np.abs(sdfs) < 1e10).astype(np.float32)
        sdf_signs = np.zeros_like(sdfs)
        if self.trunc_dist is not None:
            sdf_valid = (np.abs(sdfs) < self.trunc_dist).astype(np.float32)
            sdf_signs[(sdfs > self.trunc_dist) & (np.abs(sdfs) < 1e10)] = 1
            sdf_signs[sdfs < -self.trunc_dist] = -1
        self.coords = points
        self.sdfs = sdfs
        self.sdf_valid = sdf_valid
        self.sdf_signs = sdf_signs

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.choice(self.total_samples, size=self.batch_size)
        return {
            "coords": self.coords[idx],
            "sdf": self.sdfs[idx],
            "sdf_valid": self.sdf_valid[idx],
            "sdf_sign": self.sdf_signs[idx],
            "sdf_signs": self.sdf_signs[idx],
        }
