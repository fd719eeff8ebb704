"""2D SDF dataset from an occupancy image (port of
``miso_tpu/datasets/sdf_2d.py``).

The ground-truth SDF is the difference of the Euclidean distance transforms
of the free and the occupied masks (scipy); a batch mixes near-surface
points (surface pixels plus Gaussian noise) and uniform points, with
bilinear SDF labels.  numpy and scipy only; PIL is imported only to read an
image file.  Batches from the same ``np.random.Generator`` equal the JAX
package's.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
from scipy import ndimage

from miso_tpu_torch.datasets.base import Dataset


class Sdf2D(Dataset):
    def __init__(self, image_or_path: Union[str, np.ndarray], batch_size=2**14,
                 occupied_thresh=0.5, cell_size=1.0, near_surface_frac=0.5,
                 near_surface_std=2.0, seed=0):
        if isinstance(image_or_path, str):
            from PIL import Image
            img = np.asarray(Image.open(image_or_path).convert("L"), np.float32) / 255.0
        else:
            img = np.asarray(image_or_path, np.float32)
        occ = img < occupied_thresh  # dark = occupied
        # Signed distance in pixels: positive outside obstacles.
        d_out = ndimage.distance_transform_edt(~occ)
        d_in = ndimage.distance_transform_edt(occ)
        self.sdf = ((d_out - d_in) * cell_size).astype(np.float32)
        H, W = self.sdf.shape
        self.bound = np.array([[0.0, H * cell_size], [0.0, W * cell_size]], np.float32)
        self.cell_size = cell_size
        self.batch_size = batch_size
        self.near_surface_frac = near_surface_frac
        self.near_surface_std = near_surface_std
        self._rng = np.random.default_rng(seed)
        # Full lattice (pixel centres) for evaluation and dense supervision.
        ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        self.full_coords = (np.stack([ii, jj], -1).astype(np.float32) + 0.5) * cell_size
        self.full_sdfs = self.sdf
        surf = np.argwhere(np.abs(self.sdf) <= cell_size)
        self._surface_px = surf if len(surf) else np.zeros((1, 2), np.int64)

    def _lookup(self, coords):
        """Bilinear SDF lookup at continuous coords."""
        H, W = self.sdf.shape
        u = coords / self.cell_size - 0.5
        i0 = np.clip(np.floor(u).astype(int), 0, [H - 2, W - 2])
        f = np.clip(u - i0, 0, 1)
        s = self.sdf
        v = (s[i0[:, 0], i0[:, 1]] * (1 - f[:, 0]) * (1 - f[:, 1])
             + s[i0[:, 0] + 1, i0[:, 1]] * f[:, 0] * (1 - f[:, 1])
             + s[i0[:, 0], i0[:, 1] + 1] * (1 - f[:, 0]) * f[:, 1]
             + s[i0[:, 0] + 1, i0[:, 1] + 1] * f[:, 0] * f[:, 1])
        return v.astype(np.float32)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        n = self.batch_size
        n_surf = int(n * self.near_surface_frac)
        sel = rng.choice(len(self._surface_px), n_surf)
        px = self._surface_px[sel].astype(np.float32) + 0.5
        px += rng.normal(0, self.near_surface_std, px.shape)
        coords_surf = px * self.cell_size
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        coords_unif = rng.uniform(lo, hi, (n - n_surf, 2)).astype(np.float32)
        coords = np.concatenate([coords_surf.astype(np.float32), coords_unif])
        coords = np.clip(coords, lo + 1e-3, hi - 1e-3)
        sdf = self._lookup(coords)[:, None]
        return {
            "coords": coords,
            "sdf": sdf,
            "sdf_valid": np.ones_like(sdf),
            "sdf_sign": np.zeros_like(sdf),
            "sdf_signs": np.zeros_like(sdf),
        }
