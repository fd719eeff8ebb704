"""PointSDF baseline: a fixed point cloud with per-point latent features and
a kNN decode (port of ``miso_tpu/models/pointsdf.py``).

The support cloud (surface, noisy-surface and uniform samples) and a static
open-addressed voxel hash (one point per slot, the first point wins) are
built on the host with numpy and the native runtime, bit-identical to the
JAX package's.  A query hashes a fixed fan of neighbour cells, gathers one
candidate point per cell, keeps the k nearest valid ones (``torch.topk``;
invalid candidates sit at distance^2 1e24), decodes each neighbour's
[feature, Fourier(x - point)] through a LayerNorm + ReLU MLP and blends the
k values with inverse-distance weights (0 where no candidate is valid).
Torch ops on every device, no kernel; the MLP's products in full float32
(``ops/mlp.py::fp32_matmul``).  Same keyframe pose API as GridNet.

Trainable parameters: ``features`` (P, F), ``decoder.<i>`` (the MLP's
tensors flattened: W_0, b_0, then per later layer LayerNorm g, b, W, b),
``rot_corr``, ``trans_corr``.  Buffers: ``points``, ``hash_point_idx``,
``neighbor_dx``, ``Rwk``, ``twk``, ``bound``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from miso_tpu_torch.models.base import KeyframePoses
from miso_tpu_torch.models.grid_net import _check_device
from miso_tpu_torch.ops import se3
from miso_tpu_torch.ops.mlp import fp32_matmul

# The voxel hash sums uint32 products with wraparound in the JAX package;
# here int64 products of the cells' two's-complement low 32 bits, masked.
_PRIMES = (73856093, 19349669, 83492791)
_MASK32 = 0xFFFFFFFF


def fourier_pe(x: torch.Tensor, n_freqs: int = 6, scale: float = 1.0) -> torch.Tensor:
    """(N, 3) -> (N, 3 + 2 * 3 * n_freqs): x, then sin and cos of each
    coordinate times 2^j * scale, coordinate-major."""
    freqs = (2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)) * scale
    xb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)


def _layernorm(h, g, b):
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, correction=0)
    return (h - mu) / torch.sqrt(var + 1e-5) * g + b


def pointsdf_mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Linear, then per later layer LayerNorm, ReLU, Linear.  ``params``:
    ((W0, b0), (g, b, W, bb), ...)."""
    (W0, b0), rest = params[0], params[1:]
    h = fp32_matmul(x, W0) + b0
    for (g, b, W, bb) in rest:
        h = fp32_matmul(torch.relu(_layernorm(h, g, b)), W) + bb
    return h


def voxel_hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """(..., 3) integer cells -> (...) int64 slots: the sum of the uint32
    products with the primes, wrapped to 32 bits, modulo ``table_size``."""
    h = 0
    for k in range(3):
        h = h + (((cells[..., k] & _MASK32) * _PRIMES[k]) & _MASK32)
    return (h & _MASK32) % table_size


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as an ``index_select`` (its backward an ``index_add``)."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


class PointSDF(KeyframePoses, nn.Module):

    def __init__(self, points, features, decoder, hash_point_idx, neighbor_dx,
                 rot_corr, trans_corr, Rwk, twk, bound, *, k_neighbors: int = 8,
                 resolution: float = 0.1, sinusoidal_pe: bool = True,
                 optimize_pose: bool = False):
        super().__init__()
        self.register_buffer("points", points)
        self.features = nn.Parameter(features)
        self._layer_sizes = tuple(len(layer) for layer in decoder)
        self.decoder = nn.ParameterList([nn.Parameter(t) for layer in decoder for t in layer])
        self.register_buffer("hash_point_idx", hash_point_idx)
        self.register_buffer("neighbor_dx", neighbor_dx)
        self.rot_corr = nn.Parameter(rot_corr)
        self.trans_corr = nn.Parameter(trans_corr)
        self.register_buffer("Rwk", Rwk)
        self.register_buffer("twk", twk)
        self.register_buffer("bound", bound)
        self.k_neighbors = int(k_neighbors)
        self.resolution = float(resolution)
        self.hash_table_size = int(hash_point_idx.shape[0])
        self.sinusoidal_pe = sinusoidal_pe
        self.optimize_pose = optimize_pose
        self.anchor_kf = 0

    @property
    def decoder_params(self):
        """The MLP as ((W0, b0), (g, b, W, bb), ...)."""
        out, i = [], 0
        for n in self._layer_sizes:
            out.append(tuple(self.decoder[i:i + n]))
            i += n
        return tuple(out)

    def tree_fields(self):
        """(key, value) of the JAX PointSDF's leaves in its key-path spelling."""
        return [(".points", self.points), (".features", self.features),
                (".decoder", [list(layer) for layer in self.decoder_params]),
                (".hash_point_idx", self.hash_point_idx),
                (".neighbor_dx", self.neighbor_dx),
                (".rot_corr", self.rot_corr), (".trans_corr", self.trans_corr),
                (".Rwk", self.Rwk), (".twk", self.twk), (".bound", self.bound)]

    def neighbor_candidates(self, x: torch.Tensor):
        """(idx (B, C) int64, valid (B, C) bool): each query's candidate
        point per neighbour cell; an empty slot gives index 0, invalid."""
        # A (1,) tensor divisor: an IEEE division on every device (a Python
        # scalar divisor becomes a reciprocal multiply on the card).
        res = torch.full((1,), self.resolution, dtype=x.dtype, device=x.device)
        grid = torch.floor(x / res).to(torch.int64)
        cells = grid[:, None, :] + self.neighbor_dx[None].to(torch.int64)
        h = voxel_hash(cells, self.hash_table_size)
        idx = _rows(self.hash_point_idx, h).to(torch.int64)
        valid = idx >= 0
        return idx.clamp(min=0), valid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, k = x.shape[0], self.k_neighbors
        idx, valid = self.neighbor_candidates(x)
        diff = x[:, None, :] - _rows(self.points, idx)             # (B, C, 3)
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        d2 = torch.where(valid, d2, torch.full_like(d2, 1e24))
        neg_top, top_i = torch.topk(-d2, k, dim=1)                 # (B, k)
        nn_idx = torch.gather(idx, 1, top_i)
        dist = torch.sqrt(torch.clamp(-neg_top, min=0.0))
        nn_valid = torch.gather(valid, 1, top_i)
        diff = x[:, None, :] - _rows(self.points, nn_idx)          # (B, k, 3)
        enc = fourier_pe(diff.reshape(-1, 3)).reshape(B, k, -1) if self.sinusoidal_pe \
            else diff
        inp = torch.cat([_rows(self.features, nn_idx), enc], dim=-1)
        sdf = pointsdf_mlp_apply(self.decoder_params, inp.reshape(B * k, -1)).reshape(B, k, 1)
        w = torch.where(nn_valid, 1.0 / (dist + 1e-8), torch.zeros_like(dist))
        w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
        return torch.sum(sdf * w[..., None], dim=1)


def support_cloud(p: Dict, mesh=None, bound=None):
    """The support points (P, 3) float32, the hash table (H,) int32 (-1 =
    empty) and the neighbour fan (C, 3) int32 of a ``point`` config, built
    on the host exactly as the JAX package builds them."""
    from miso_tpu_torch.datasets.sdf_3d import as_mesh

    total = int(p.get("total_samples", 50000))
    noise = float(p.get("noise_threshold", 0.02))
    r_surf = float(p.get("sample_ratio_surface", 0.4))
    r_rand = float(p.get("sample_ratio_random", 0.2))
    res = float(p.get("resolution", 0.1))
    H = int(p.get("hash_table_size", 2 ** 20))
    num_nei = int(p.get("num_nei_cells", 2))
    alpha = float(p.get("search_alpha", 1.0))
    bound_np = np.asarray(bound if bound is not None else p.get("bound", [[-1, 1]] * 3),
                          np.float32)
    rng = np.random.default_rng(42)
    if mesh is not None:
        m = as_mesh(mesh)
        n_surf = int(total * r_surf)
        n_rand = int(total * r_rand)
        pts_surf = m.sample_surface(n_surf, seed=1)
        pts_near = m.sample_surface(n_surf, seed=2) + \
            rng.normal(0, noise, (n_surf, 3)).astype(np.float32)
        pts_rand = rng.uniform(bound_np[:, 0], bound_np[:, 1],
                               (total - 2 * n_surf if total - 2 * n_surf > 0 else n_rand, 3)
                               ).astype(np.float32)
        points = np.concatenate([pts_surf, pts_near, pts_rand])[:total]
    else:
        points = rng.uniform(bound_np[:, 0], bound_np[:, 1], (total, 3)).astype(np.float32)

    r = np.arange(-num_nei, num_nei + 1)
    coords = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    keep = (coords ** 2).sum(-1) < (num_nei + alpha) ** 2
    neighbor_dx = coords[keep].astype(np.int32)

    table = np.full((H,), -1, np.int64)
    gc = np.floor(points / res).astype(np.int32)
    with np.errstate(over="ignore"):
        prod = gc.astype(np.uint32) * np.array(_PRIMES, np.uint32)[None, :]
        hv = (prod[:, 0] + prod[:, 1] + prod[:, 2]) % np.uint32(H)
    # First point per slot wins: write in reverse so index 0 lands last.
    order = np.arange(len(points))[::-1]
    table[hv[order]] = order
    return points, table.astype(np.int32), neighbor_dx, bound_np


def pointsdf_settings(cfg_model: Dict):
    """The static settings of a PointSDF's config (``point``: k_neighbors,
    resolution; ``decoder.sinusoidal_pe``; ``pose.optimize``)."""
    p = cfg_model.get("point", {})
    return dict(k_neighbors=int(p.get("k_neighbors", 8)),
                resolution=float(p.get("resolution", 0.1)),
                sinusoidal_pe=bool(cfg_model.get("decoder", {}).get("sinusoidal_pe", True)),
                optimize_pose=bool(cfg_model.get("pose", {}).get("optimize", False)))


def create_pointsdf(cfg_model: Dict, mesh=None, bound=None, dtype=torch.float32,
                    generator: Optional[torch.Generator] = None, device="cuda") -> PointSDF:
    """Build a PointSDF from a model config (``point``, ``decoder``,
    ``pose``): the support cloud from ``mesh`` (uniform in the bound
    without one), per-point features from N(0, 0.01^2) and the MLP's
    weights from U(+-1/sqrt(fan_in)) drawn from ``generator`` (a CPU
    generator); K poses from ``pose.num_frames``, else ``num_poses``."""
    device = _check_device(device)
    p = cfg_model.get("point", {})
    dcfg = cfg_model.get("decoder", {})
    pcfg = cfg_model.get("pose", {})
    points, table, neighbor_dx, bound_np = support_cloud(p, mesh, bound)
    fdim = int(p.get("feature_dim", 8))
    feats = torch.randn((len(points), fdim), generator=generator, dtype=dtype) * 0.01
    enc_dim = 3 + 2 * 3 * 6 if dcfg.get("sinusoidal_pe", True) else 3
    hidden = int(dcfg.get("hidden_dim", 64))
    n_layers = int(dcfg.get("num_layers", 3))
    dims = [fdim + enc_dim] + [hidden] * (n_layers - 1) + [int(dcfg.get("output_dim", 1))]

    def uniform(fin, fout):
        lim = 1.0 / math.sqrt(fin)
        return ((torch.rand((fin, fout), generator=generator, dtype=dtype) * 2.0 - 1.0)
                * lim).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    decoder = [(uniform(dims[0], dims[1]), zeros(dims[1]))]
    for i in range(1, len(dims) - 1):
        decoder.append((torch.ones((dims[i],), dtype=dtype, device=device), zeros(dims[i]),
                        uniform(dims[i], dims[i + 1]), zeros(dims[i + 1])))
    K = int(pcfg.get("num_frames", pcfg.get("num_poses", 1)))
    return PointSDF(
        torch.as_tensor(points, device=device), feats.to(device), decoder,
        torch.as_tensor(table, device=device), torch.as_tensor(neighbor_dx, device=device),
        rot_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        trans_corr=torch.zeros((K, 3), dtype=dtype, device=device),
        Rwk=se3.identity_rotations(K, dtype, device),
        twk=torch.zeros((K, 3), dtype=dtype, device=device),
        bound=torch.as_tensor(bound_np, device=device), **pointsdf_settings(cfg_model))
