"""Feature-grid interpolation (port of ``miso_tpu/ops/interp.py``).

Semantics match ``F.grid_sample(..., align_corners=False,
padding_mode='zeros')`` after normalising by the grid bound:

  * the grid spans the bound with ``size`` cells per axis; feature i sits
    at the centre of cell i, ``bound_min + (i + 0.5) * extent / size``;
  * a query is linearly interpolated from its 2^d surrounding corners;
  * corners outside the grid contribute zero (zeros padding).

Everything is computed in continuous index space,
``u = (x - lo) / (hi - lo) * size - 0.5``, as a gather plus lerp that
autograd differentiates to any order (``index_select`` and its backward
``index_add`` are both differentiable).

Grid storage is channel-last ``(g0, ..., g_{d-1}, F)``, array axis k being
world axis k, as in the JAX package.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from miso_tpu_torch.ops.mlp import mlp_apply


def index_coords(x: torch.Tensor, bound: torch.Tensor, size) -> torch.Tensor:
    """World coords (N, d) -> continuous cell-index coords (N, d)."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (x - lo) / (hi - lo) * size - 0.5


def normalize_coordinates(x: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Map coords to [-1, 1] over the bound."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return 2.0 * (x - lo) / (hi - lo) - 1.0


def denormalize_coordinates(xn: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_coordinates`."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (xn + 1.0) * 0.5 * (hi - lo) + lo


def corner_indices_and_weights(x: torch.Tensor, bound: torch.Tensor,
                               spatial: Sequence[int],
                               size: Optional[torch.Tensor] = None):
    """Per-corner flat indices and lerp weights.

    ``spatial`` is the static storage shape (it sets the strides);
    ``size`` is an optional (d,) runtime *logical* size for storage padded
    beyond it (it sets validity and clipping).

    Returns (lin (2^d, N) int64 flat indices into the row-major grid,
    w (2^d, N) weights with zeros-padding validity folded in).
    """
    d = x.shape[-1]
    if size is not None:
        size = torch.as_tensor(size, device=x.device)
    cols = []
    for k in range(d):
        if size is None:
            nk_f = float(spatial[k])
            nk_i = int(spatial[k])
        else:
            nk_f = size[k].to(x.dtype)
            nk_i = size[k].to(torch.int64)
        lo = bound[k, 0]
        hi = bound[k, 1]
        u = (x[:, k] - lo) / (hi - lo) * nk_f - 0.5
        i0f = torch.floor(u)
        cols.append((i0f.to(torch.int64), u - i0f, nk_i))
    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * int(spatial[k + 1])
    lin_all, w_all = [], []
    for corner in itertools.product((0, 1), repeat=d):
        lin = None
        w = None
        ok = None
        for k in range(d):
            i0k, frk, nk_i = cols[k]
            ik = i0k + corner[k]
            ok_k = (ik >= 0) & (ik < nk_i)
            ok = ok_k if ok is None else ok & ok_k
            ic = ik.clamp(min=0)
            ic = (ic.clamp(max=nk_i - 1) if isinstance(nk_i, int)
                  else torch.minimum(ic, nk_i - 1))
            term = ic * strides[k]
            lin = term if lin is None else lin + term
            wk = frk if corner[k] == 1 else 1.0 - frk
            w = wk if w is None else w * wk
        lin_all.append(lin)
        w_all.append(w * ok.to(w.dtype))
    return torch.stack(lin_all), torch.stack(w_all)


def grid_interpolate(grid: torch.Tensor, x: torch.Tensor, bound: torch.Tensor,
                     size: Optional[torch.Tensor] = None,
                     spatial: Optional[Sequence[int]] = None,
                     fdim: Optional[int] = None) -> torch.Tensor:
    """Multilinear interpolation with zeros padding.

    Args:
      grid: (g0, ..., g_{d-1}, F) feature grid, or folded storage with the
        same row-major element order plus explicit ``spatial``/``fdim``.
      x: (N, d) world-frame query coordinates.
      bound: (d, 2) [min, max] per axis.
      size: optional (d,) runtime logical grid size when ``grid`` is padded
        to a larger static shape.

    Returns (N, F) features, differentiable to any order wrt ``grid`` and ``x``.
    """
    d = x.shape[-1]
    if spatial is None:
        spatial = tuple(grid.shape[:-1])
        if len(spatial) != d:
            raise ValueError(f"grid rank {len(spatial)} != coord dim {d}")
    F = int(fdim) if fdim is not None else grid.shape[-1]
    lin, w = corner_indices_and_weights(x, bound, spatial, size)
    return _gather_lerp_channels(grid, lin, w, F)


def _gather_lerp_channels(grid, lin, w, F):
    """Weighted corner gather: one row gather of all F channels per corner.

    ``lin``: (2^d, N) cell indices, ``w``: (2^d, N) weights.  The corner
    sum runs over the leading axis, as the JAX version's does.
    """
    rows = torch.index_select(grid.reshape(-1, F), 0, lin.reshape(-1))
    rows = rows.reshape(*lin.shape, F)
    return torch.sum(w.unsqueeze(-1) * rows, dim=0)


def multi_level_interpolate(grids: Sequence[torch.Tensor], x: torch.Tensor,
                            bound: torch.Tensor,
                            ignore_level: Optional[torch.Tensor] = None,
                            sizes: Optional[Sequence[torch.Tensor]] = None,
                            interpolate: Callable = None) -> torch.Tensor:
    """Interpolate every level and concatenate along channels.

    ``ignore_level`` is an optional (L,) float/bool tensor; ignored levels
    contribute zeros.  ``sizes`` optionally gives each level's logical
    size (see :func:`grid_interpolate`).  ``interpolate(grid, x, bound,
    size)`` interpolates one level; :func:`grid_interpolate` when None.
    """
    interpolate = interpolate or grid_interpolate
    feats = []
    for level, g in enumerate(grids):
        f = interpolate(g, x, bound, None if sizes is None else sizes[level])
        if ignore_level is not None:
            f = f * (1.0 - ignore_level[level].to(f.dtype))
        feats.append(f)
    return torch.cat(feats, dim=-1)


def grid_decode(feats, x, decoder_params=None, pos_invariant=True,
                decode: Callable = None):
    """Concat-levels features -> decoder MLP; None decoder is the identity.

    ``decode(params, inputs)`` runs the MLP; :func:`ops.mlp.mlp_apply` when
    None."""
    if decoder_params is None:
        return feats
    inputs = feats if pos_invariant else torch.cat([feats, x], dim=-1)
    return (decode or mlp_apply)(decoder_params, inputs)


def vertex_positions(spatial: Sequence[int], bound: torch.Tensor) -> torch.Tensor:
    """World-frame centres of all grid cells, shape (prod(spatial), d)."""
    axes = []
    for k, n in enumerate(spatial):
        lo = bound[k, 0]
        hi = bound[k, 1]
        step = (hi - lo) / n
        axes.append(lo + (torch.arange(n, device=bound.device,
                                       dtype=bound.dtype) + 0.5) * step)
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def grid_shape_for_bound(bound, cell_size, d=3):
    """ceil((hi - lo) / cell_size) per axis, as Python ints (static shapes)."""
    if isinstance(bound, torch.Tensor):
        bound = bound.detach().cpu().numpy()
    b = np.asarray(bound, dtype=np.float64)
    n = np.ceil((b[:, 1] - b[:, 0]) / float(cell_size) - 1e-9).astype(int)
    return tuple(int(v) for v in n[:d])
