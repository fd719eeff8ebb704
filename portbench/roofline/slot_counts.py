"""Operations and bytes of the slot-id interp kernels (each point read
against its own slot of an atlas level's stacked storage), from shapes and
from the rows the points touch, as ``counts.py`` counts the single-grid
kernels: each input byte once, each output byte once, a table by the rows
its points touch.  ``counts.least_s`` turns them into least seconds.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def touched_rows(ids: torch.Tensor, x: torch.Tensor, bounds: torch.Tensor,
                 sizes: torch.Tensor, dims: Sequence[int]) -> int:
    """Distinct rows of the (S, *dims) storage that the 8 corners of the
    points read: point i in slot ids[i] with bound bounds[ids[i]] and logical
    size sizes[ids[i]]; corners beyond the logical size read nothing."""
    ids = ids.long()
    b = bounds[ids]
    n = sizes[ids].to(x.dtype)
    i0 = torch.floor((x - b[:, :, 0]) / (b[:, :, 1] - b[:, :, 0]) * n - 0.5).to(torch.int64)
    size = sizes[ids].long()
    rows = []
    for c in range(8):
        ik = i0 + torch.tensor([(c >> 2) & 1, (c >> 1) & 1, c & 1], device=x.device)
        ok = ((ik >= 0) & (ik < size)).all(-1)
        ik, slot = ik[ok], ids[ok]
        rows.append(((slot * dims[0] + ik[:, 0]) * dims[1] + ik[:, 1]) * dims[2] + ik[:, 2])
    return int(torch.unique(torch.cat(rows)).numel())


def forward(n: int, fdim: int, rows: int, elem: int = 4) -> Dict[str, float]:
    """One slot-id read of n points: the points, their slot ids and the
    touched rows in, the features out; 8 corners of F multiply-adds a point."""
    return dict(flops_simt=2.0 * 8 * fdim * n,
                nbytes=(12.0 + 4.0) * n + rows * fdim * elem + 4.0 * fdim * n)


def points_backward(n: int, fdim: int, rows: int, elem: int = 4) -> Dict[str, float]:
    """The points-only backward of a slot-id read: the points, their slot
    ids, the features' cotangent and the touched rows in, 12 bytes of points'
    gradient a point out; a point's 8 corner rows dotted with its cotangent
    and the 8 weights' derivatives in each of 3 axes."""
    return dict(flops_simt=2.0 * (8 * fdim + 8 * 3) * n,
                nbytes=(12.0 + 4.0) * n + 4.0 * fdim * n + rows * fdim * elem + 12.0 * n)
