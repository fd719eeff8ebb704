"""Spatially sharded feature grids: one grid's world-x axis split into slabs
over the ranks (port of ``miso_tpu/parallel/spatial.py``).

Protocol per query batch (the points replicated on every rank), as in the
JAX package:

  1. each rank holds an x-slab ``(S, Y, Z, F)`` of the grid plus a one-row
     halo from its right neighbour; the last rank's halo is zeros, which is
     the zeros-padding rule;
  2. a point's global base cell ``i0x`` names its one owner,
     ``clip(i0x, 0, X - 1) // S``, and the owner does the whole lerp, with
     validity against the global logical size, so padding rows and corners
     out of bound give zero;
  3. a sum over the ranks assembles the replicated result.

The halo exchange is an all-reduce: each rank writes its first row into
slot r of a ``(D, Y, Z, F)`` buffer of zeros and reads slot r + 1, and the
backward returns the halo's gradient to the neighbour's first row the same
way.  The owner's lerp is ``ops/tiled_interp.py::grid_interpolate_dispatch``
on the slab and its halo (the interp kernel on the card), with the slab's
own bound (the global one from ``shift`` cells on) and logical size
``X - shift``.  The shifted bound moves a point's cell coordinate by
rounding, so each owned point's x is first moved by a few of the bound's
ulps where that rounding would put it in another cell than the global
query's
(:func:`_snap_to_cell`): every point lerps in the unsharded query's cell,
its value within an ulp-sized weight, its gradient the same one-sided
derivative at a cell face.  The slab's logical size may exceed its rows
(``X - shift`` counts the rows of the ranks to its right); an owned point's
corners never pass its halo row, and the kernel clips to the storage.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from miso_tpu_torch.ops.tiled_interp import grid_interpolate_dispatch

_SNAP_STEPS = 4


def pad_to_multiple(grid: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended to axis 0 so it divides into n slabs."""
    pad = (-grid.shape[0]) % n
    if pad == 0:
        return grid
    return torch.cat([grid, grid.new_zeros((pad,) + tuple(grid.shape[1:]))])


def shard_grid_spatial(grid: torch.Tensor, mesh, axis: str = "grid") -> Tuple[torch.Tensor, int]:
    """(this rank's slab of ``grid`` padded to a multiple of the axis size,
    the logical X before padding).  The JAX package returns the global
    sharded array; here each rank keeps only its rows."""
    ax = mesh.axis(axis)
    g = pad_to_multiple(grid, ax.size)
    return g[ax.rows(g.shape[0])].clone(), int(grid.shape[0])


class _HaloFromRight(torch.autograd.Function):
    """The right neighbour's first row (1, Y, Z, F); zeros on the last rank."""

    @staticmethod
    def forward(ctx, slab, group, index, size):
        ctx.group, ctx.index, ctx.size, ctx.shape = group, index, size, slab.shape
        buf = slab.new_zeros((size,) + tuple(slab.shape[1:]))
        buf[index] = slab[0].detach()
        dist.all_reduce(buf, group=group)
        if index + 1 < size:
            return buf[index + 1:index + 2].clone()
        return slab.new_zeros((1,) + tuple(slab.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        buf = g.new_zeros((ctx.size,) + tuple(ctx.shape[1:]))
        if ctx.index + 1 < ctx.size:
            buf[ctx.index + 1] = g[0]
        dist.all_reduce(buf, group=ctx.group)
        d = g.new_zeros(ctx.shape)
        d[0] = buf[ctx.index]
        return d, None, None, None


def _halo(slab: torch.Tensor, ax) -> torch.Tensor:
    if ax.group is None:
        return slab.new_zeros((1,) + tuple(slab.shape[1:]))
    return _HaloFromRight.apply(slab, ax.group, ax.index, ax.size)


def _cell_u(x0, lo, hi, n):
    """Continuous cell index along one axis, rounded op by op as every interp
    kernel and its plain version round it."""
    return (x0 - lo) / (hi - lo) * n - 0.5


@torch.no_grad()
def _snap_to_cell(x0, lo, hi, n, target):
    """x0 moved towards ``floor(_cell_u) == target`` in steps of one ulp of
    the bound's largest coordinate, the size of the rounding that put it
    elsewhere (at most ``_SNAP_STEPS``, no host read); points already
    there stay."""
    m = torch.maximum(torch.abs(lo), torch.abs(hi))
    q = torch.nextafter(m, m + 1) - m
    for _ in range(_SNAP_STEPS):
        i0 = torch.floor(_cell_u(x0, lo, hi, n))
        x0 = torch.where(i0 < target, x0 + q, torch.where(i0 > target, x0 - q, x0))
    return x0


def sharded_grid_interpolate(slab: torch.Tensor, x: torch.Tensor, bound, x_logical: int,
                             mesh, axis: str = "grid") -> torch.Tensor:
    """Trilinear interpolation (zeros padding, ``align_corners=False``) of an
    x-sharded grid at replicated points ``x`` (N, 3): each rank's
    :func:`shard_grid_spatial` slab, the replicated result (N, F) on every
    rank.  Differentiable in the slab and in ``x`` (the points' gradient
    summed over the ranks, the halo's gradient sent back to its owner)."""
    ax = mesh.axis(axis)
    S = int(slab.shape[0])
    shift = ax.index * S
    bound = torch.as_tensor(bound, dtype=torch.float32, device=x.device)
    lo, hi = bound[0, 0], bound[0, 1]
    xq = ax.pvary(x)
    with torch.no_grad():
        i0 = torch.floor(_cell_u(xq[:, 0], lo, hi, float(x_logical)))
        mine = torch.clamp(i0, 0, x_logical - 1).div(S, rounding_mode="floor") == ax.index
    f_ext = torch.cat([slab, _halo(slab, ax)])
    # Every rank runs the same graph, so the collectives of the backward
    # pair up; a slab of padding rows alone (n_s <= 0) owns no point and
    # queries a one-row grid beyond the bound.
    n_s = max(x_logical - shift, 1)
    cell = (hi - lo) / x_logical
    lo_s = lo + shift * cell if shift else lo
    hi_s = hi if x_logical > shift else lo_s + cell
    bound_s = torch.stack([torch.stack([lo_s, hi_s]), bound[1], bound[2]])
    size_s = torch.tensor([n_s] + list(slab.shape[1:-1]), dtype=torch.int32, device=x.device)
    # A point another rank owns is queried at the slab's first cell centre
    # (its result is dropped): no corner of it lies past the slab's rows.
    with torch.no_grad():
        x0 = xq[:, 0].detach()
        if shift:
            x0 = _snap_to_cell(x0, lo_s, hi_s, float(n_s), i0 - shift)
        x0 = torch.where(mine, x0, (lo_s + 0.5 * cell).expand_as(x0))
    xq = torch.cat([xq[:, :1] + (x0 - xq[:, 0].detach())[:, None], xq[:, 1:]], dim=1)
    out = grid_interpolate_dispatch(f_ext, xq.contiguous(), bound_s, size_s)
    out = torch.where(mine[:, None], out, torch.zeros_like(out))
    return ax.psum(out)


def sharded_multi_level_interpolate(slabs: Sequence[torch.Tensor], x: torch.Tensor, bound,
                                    x_logicals: Sequence[int], mesh,
                                    axis: str = "grid") -> torch.Tensor:
    """Per-level :func:`sharded_grid_interpolate`, concatenated."""
    return torch.cat([sharded_grid_interpolate(g, x, bound, xl, mesh, axis)
                      for g, xl in zip(slabs, x_logicals)], dim=-1)


def sharded_sdf_train_step(decoder_apply, mesh, axis: str = "grid", lr: float = 1e-3):
    """A masked-Adam mapping step over an x-sharded multi-level grid.

    step(slabs, opt_state, x_logicals, bound, x, y, valid) -> (slabs,
    opt_state, loss): the loss ``sum((decoder_apply(f) - y)^2 * valid) /
    max(sum(valid), 1)`` at replicated points; each rank's slabs and Adam
    moments (``opt_state`` None on the first step) stay on it and are
    updated in place from their own gradients, with only the halo rows and
    the per-point sums crossing the ranks.
    """
    from miso_tpu_torch.models.base import tree_full_mask
    from miso_tpu_torch.train.optim import masked_adam_init, masked_adam_update

    def step(slabs, opt_state, x_logicals, bound, x, y, valid):
        slabs = [s.requires_grad_() for s in slabs]
        f = sharded_multi_level_interpolate(slabs, x, bound, x_logicals, mesh, axis)
        se = (decoder_apply(f) - y) ** 2 * valid
        loss = torch.sum(se) / torch.clamp(torch.sum(valid), min=1.0)
        grads = torch.autograd.grad(loss, slabs)
        params = {str(i): s for i, s in enumerate(slabs)}
        if opt_state is None:
            opt_state = masked_adam_init(params)
        masked_adam_update({str(i): g for i, g in enumerate(grads)}, opt_state, params,
                           tree_full_mask(params), lr=lr)
        return slabs, opt_state, loss.detach()

    return step
