"""Plain PyTorch reference of MISO's latent submap alignment at one level:
submap pose corrections on the so(3) exponential, the pairs whose bounds
overlap, each pair's source vertices read against the destination submap,
the weighted L2 pair loss, and masked Adam with submap 0 anchored.

Written from the method's equations, not from the program: it imports
nothing of the program and takes no tensor the program made except the
alignment coordinates it is asked to check (:func:`selection_failures`) and
follow.  Everything runs in float32 with TF32 off; ``precision="tf32"``
rounds the inputs of every matrix product, forward and backward, to TF32 (10
mantissa bits) on the CPU and the card alike: the control the comparison
has to reject.  A point is moved by a matrix product, so the control moves
it by a rounded rotation.

Submaps are lists of tables, one (X, Y, Z, F) a level at the submap's
logical shape, value i at the centre of cell i of the submap's bound
(``field.trilinear``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import field

B1, B2, EPS = 0.9, 0.999, 1e-8
OVERLAP = 1e-2       # a pair aligns where more than this share of src's finest centres lie in dst
NORM_THRESH = 1e-5   # a vertex is selectable where its multi-level feature norm exceeds this
WEIGHT = 3000.0      # MISO's weight of the latent alignment loss


class _Tf32Product(torch.autograd.Function):
    """a @ b (batched) with the inputs of every product rounded to TF32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = field.tf32_round(a), field.tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = field.tf32_round(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in field.PRECISIONS:
        raise ValueError(f"precision must be one of {field.PRECISIONS}, not {precision!r}")
    return _Tf32Product.apply(a, b) if precision == "tf32" else a @ b


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3): I + sin(th)/th W +
    (1 - cos(th))/th^2 W^2, with the series of both factors near th = 0."""
    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    W = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    th2 = (w * w).sum(-1)[..., None, None]
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * W + b * (W[..., :, :, None]
                                                                     * W[..., None, :, :]).sum(-2)


def corrected(R0, t0, dr, dt, precision: str):
    """Each submap's pose with its correction: (R0 Exp(dr), t0 + dt)."""
    return product(R0, so3_exp(dr), precision), t0 + dt


def to_world(x, R, t, precision: str):
    return product(x, R.transpose(-1, -2), precision) + t


def from_world(x, R, t, precision: str):
    return product(x - t, R, precision)


def inside(x: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """(N,) 1 where x lies in the closed bound."""
    return ((x >= bound[:, 0]) & (x <= bound[:, 1])).all(-1).to(x.dtype)


def cell_centres(bound: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Every cell centre of a grid over ``bound``, x slowest."""
    axes = [bound[k, 0] + (torch.arange(n, dtype=torch.float32, device=bound.device) + 0.5)
            * ((bound[k, 1] - bound[k, 0]) / n) for k, n in enumerate(shape)]
    return torch.stack([m.reshape(-1) for m in torch.meshgrid(*axes, indexing="ij")], -1)


@torch.no_grad()
def overlapping_pairs(R, t, bounds, finest: Sequence[Sequence[int]],
                      chunk: int = 1 << 21) -> List[Tuple[int, int]]:
    """(src, dst), src < dst, where more than OVERLAP of src's finest cell
    centres, moved by the two poses, fall inside dst's bound."""
    S = len(finest)
    out = []
    for s in range(S):
        verts = cell_centres(bounds[s], finest[s])
        for d in range(s + 1, S):
            hits = 0.0
            for v in verts.split(chunk):
                x = from_world(to_world(v, R[s], t[s], "fp32"), R[d], t[d], "fp32")
                hits += float(inside(x, bounds[d]).sum())
            if hits / verts.shape[0] > OVERLAP:
                out.append((s, d))
    return out


def features(tables: Sequence[torch.Tensor], x, bound, level: int) -> torch.Tensor:
    """Levels 0..level of a submap at x, concatenated."""
    return torch.cat([field.trilinear(tb, x, bound) for tb in tables[:level + 1]], -1)


@torch.no_grad()
def selection_failures(submaps, bounds, coords, valid, level: int, cap: int,
                       chunk: int = 1 << 21) -> Tuple[int, int]:
    """(failures, rows) of the alignment coordinates at ``level``: coords
    (S, P, 3), valid (S, P, 1).  A valid row fails unless it is a cell centre
    of its submap's grid at that level, not repeated, whose feature norm over
    every level exceeds NORM_THRESH; a submap fails by the difference between
    its valid rows and min(cap, its selectable centres)."""
    fails = 0
    S, P = coords.shape[:2]
    for s in range(S):
        tables, bound = submaps[s], bounds[s]
        shape = list(tables[level].shape[:3])
        n = torch.tensor(shape, dtype=torch.float32, device=coords.device)
        on = valid[s, :, 0] > 0
        x = coords[s][on]
        u = (x - bound[:, 0]) / (bound[:, 1] - bound[:, 0]) * n - 0.5
        i = torch.round(u)
        centre = ((u - i).abs() < 1e-3).all(-1) & ((i >= 0) & (i < n)).all(-1)
        norm = torch.linalg.vector_norm(features(tables, x, bound, len(tables) - 1), dim=-1)
        ok = centre & (norm > NORM_THRESH)
        cells = i[centre].to(torch.int64)
        flat = (cells[:, 0] * shape[1] + cells[:, 1]) * shape[2] + cells[:, 2]
        fails += int((~ok).sum()) + int(flat.numel() - torch.unique(flat).numel())
        selectable = 0
        for v in cell_centres(bound, shape).split(chunk):
            f = features(tables, v, bound, len(tables) - 1)
            selectable += int((torch.linalg.vector_norm(f, dim=-1) > NORM_THRESH).sum())
        fails += abs(int(on.sum()) - min(cap, selectable))
    return fails, S * P


def pair_loss_total(submaps, bounds, src_feats, coords, valid, pairs, R, t, level: int,
                    precision: str) -> torch.Tensor:
    """WEIGHT times the sum over pairs of the masked mean squared feature
    difference (over points and the levels' channels) between src at its
    vertices and dst at those vertices moved into its frame."""
    total = 0.0
    for s, d in pairs:
        x = from_world(to_world(coords[s], R[s], t[s], precision), R[d], t[d], precision)
        m = valid[s, :, 0] * inside(x, bounds[d])
        diff = src_feats[s] - features(submaps[d], x, bounds[d], level)
        total = total + (m[:, None] * diff * diff).sum() / (
            torch.clamp(m.sum(), min=1.0) * diff.shape[-1])
    return total * WEIGHT


def align_steps(submaps, bounds, R0, t0, coords, valid, pairs, level: int, steps: int,
                lr: float, precision: str = "fp32") -> Dict:
    """``steps`` masked-Adam steps over the submap pose corrections (rot, trans),
    from zero, submap 0 held: returns the losses, the first step's gradient
    as Adam takes it (frozen rows 0, non-finite entries 0) and each
    correction after the steps."""
    S = R0.shape[0]
    dev = R0.device
    leaves = {"sub_rot_corr": torch.zeros((S, 3), device=dev),
              "sub_trans_corr": torch.zeros((S, 3), device=dev)}
    rows = torch.ones((S, 1), device=dev)
    rows[0] = 0.0
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses, first = [], {}
    with field.matmul_precision(precision, dev):
        with torch.no_grad():
            src_feats = {s: features(submaps[s], coords[s], bounds[s], level)
                         for s in {p[0] for p in pairs}}
        for k in range(1, steps + 1):
            for p in leaves.values():
                p.requires_grad_(True)
            R, t = corrected(R0, t0, leaves["sub_rot_corr"], leaves["sub_trans_corr"], precision)
            loss = pair_loss_total(submaps, bounds, src_feats, coords, valid, pairs, R, t,
                                   level, precision)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for p in leaves.values():
                    p.requires_grad_(False)
                on = rows * float(torch.isfinite(loss))
                c1 = 1.0 - torch.pow(torch.tensor(B1), float(k))
                c2 = 1.0 - torch.pow(torch.tensor(B2), float(k))
                for (name, p), g in zip(leaves.items(), grads):
                    g = torch.nan_to_num(g) * on
                    if k == 1:
                        first[name] = g.clone()
                    m[name] = torch.where(on > 0, B1 * m[name] + (1 - B1) * g, m[name])
                    v2[name] = torch.where(on > 0, B2 * v2[name] + (1 - B2) * g * g, v2[name])
                    p.sub_(lr * on * (m[name] / c1.to(dev)) / (torch.sqrt(v2[name] / c2.to(dev))
                                                               + EPS))
            losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "changes": {k: v.detach().clone() for k, v in leaves.items()}}
