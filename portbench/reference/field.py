"""Plain PyTorch reference of the mapping step: a multiresolution feature grid
read by trilinear interpolation, a ReLU MLP decoder, per-point keyframe poses,
the MISO mapping loss and masked Adam.

Written from the method's equations, not from the program: it imports nothing
of the program and takes no tensor the program made.  Everything runs in
float32; ``precision="tf32"`` rounds the inputs of every matrix product to
TF32 (10 mantissa bits), the control that the comparison has to reject.  On
the card that is the hardware's TF32 path; on the CPU the rounding is
emulated.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

PRECISIONS = ("fp32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (the top 10 mantissa bits), nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """TF32 on for ``"tf32"`` on the card, off for ``"fp32"``; restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Tf32MatMul(torch.autograd.Function):
    """a @ b with the inputs of every product, forward and backward, rounded
    to TF32, as the card's TF32 path computes them."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.T, a.T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b; on the CPU a ``"tf32"`` product is emulated."""
    if precision == "tf32" and a.device.type != "cuda":
        return _Tf32MatMul.apply(a, b)
    return a @ b


def trilinear(table: torch.Tensor, x: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Trilinear read of a (X, Y, Z, F) table whose value i sits at the centre
    of cell i of the bound; corners outside the table read zero.
    u = (x - lo) / (hi - lo) * n - 0.5 in cell units, rounded op by op."""
    dims = table.shape[:3]
    F = table.shape[3]
    lo, hi = bound[:, 0], bound[:, 1]
    n = torch.tensor([float(d) for d in dims], dtype=x.dtype, device=x.device)
    u = (x - lo) / (hi - lo) * n - 0.5
    i0 = torch.floor(u)
    frac = u - i0
    i0 = i0.to(torch.int64)
    flat = table.reshape(-1, F)
    out = torch.zeros((x.shape[0], F), dtype=table.dtype, device=x.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                idx, w, ok = [], None, None
                for k, c in enumerate((cx, cy, cz)):
                    ik = i0[:, k] + c
                    okk = (ik >= 0) & (ik < dims[k])
                    ok = okk if ok is None else ok & okk
                    idx.append(ik.clamp(0, dims[k] - 1))
                    wk = frac[:, k] if c else 1.0 - frac[:, k]
                    w = wk if w is None else w * wk
                row = (idx[0] * dims[1] + idx[1]) * dims[2] + idx[2]
                w = torch.where(ok, w, torch.zeros_like(w))
                out = out + w[:, None] * flat.index_select(0, row)
    return out


def mlp(layers: Sequence, h: torch.Tensor, precision: str) -> torch.Tensor:
    """ReLU MLP over ((W (in, out), b (out,)), ...), linear last layer."""
    for i, (W, b) in enumerate(layers):
        h = matmul(h, W, precision) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def to_world(points: torch.Tensor, ids: torch.Tensor, R: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """R[id] p + t[id] per point, in float32 elementwise sums."""
    Ri, ti = R[ids.long()], t[ids.long()]
    return (Ri * points[:, None, :]).sum(-1) + ti


def field(tables: Sequence[torch.Tensor], decoder: Sequence, x: torch.Tensor,
          bound: torch.Tensor, precision: str) -> torch.Tensor:
    """SDF of world points: every level read and concatenated, then decoded."""
    feats = torch.cat([trilinear(t, x, bound) for t in tables], dim=-1)
    return mlp(decoder, feats, precision)


def mapping_loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor], loss_type: str,
                 weight_sdf: float, weight_fs: float, trunc_dist: float) -> torch.Tensor:
    """MISO's mapping loss without its eikonal term: the valid rows' L1 or L2
    SDF residual, plus on rows marked free space max(relu(pred - gt),
    relu(trunc - pred)); both means over the whole batch."""
    gt, valid, sign = batch["sdf"], batch["sdf_valid"], batch["sdf_signs"]
    r = pred - gt
    per = torch.abs(r) if loss_type == "L1" else r * r
    if loss_type not in ("L1", "L2"):
        raise ValueError(f"loss_type must be L1 or L2, not {loss_type!r}")
    sdf = torch.mean(batch["weights"] * torch.where(valid == 1, per, torch.zeros_like(per)))
    free = sign == 1
    zero = torch.zeros_like(pred)
    fs = torch.maximum(torch.where(free, torch.relu(pred - gt), zero),
                       torch.where(free, torch.relu(trunc_dist - pred), zero))
    total = weight_sdf * sdf
    if weight_fs > 0:
        total = total + weight_fs * torch.mean(fs)
    return total


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) on the leaves it is given, in
    float32 throughout: the decay rates are float32 numbers and the bias
    corrections 1 - b^t are computed in float32."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        f32 = dict(dtype=torch.float32)
        c1 = 1.0 - torch.tensor(self.b1, **f32) ** self.t
        c2 = 1.0 - torch.tensor(self.b2, **f32) ** self.t
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            c1d, c2d = c1.to(p.device), c2.to(p.device)
            p.sub_(self.lr * (self.m[k] / c1d) / (torch.sqrt(self.v[k] / c2d) + self.eps))


def train_steps(tables: List[torch.Tensor], decoder: Sequence, R: torch.Tensor,
                t: torch.Tensor, bound: torch.Tensor, batches: Sequence[Dict],
                loss_kw: Dict, lr: float, train_decoder: bool, precision: str):
    """len(batches) mapping steps from the given leaves (changed in place).

    Returns the losses and the first step's gradient of every trained leaf.
    Poses are not trained."""
    dev = tables[0].device
    leaves = {f"features.{i}": tb for i, tb in enumerate(tables)}
    if train_decoder:
        for i, (W, b) in enumerate(decoder):
            leaves[f"decoder.{2 * i}"], leaves[f"decoder.{2 * i + 1}"] = W, b
    opt = Adam(leaves, lr)
    losses, first_grads = [], None
    with matmul_precision(precision, dev):
        for batch in batches:
            for v in leaves.values():
                v.requires_grad_(True)
            x = to_world(batch["coords_frame"], batch["sample_frame_ids"], R, t)
            loss = mapping_loss(field(tables, decoder, x, bound, precision), batch, **loss_kw)
            names = list(leaves)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
            for v in leaves.values():
                v.requires_grad_(False)
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in grads.items()}
            opt.step(leaves, grads)
            losses.append(float(loss.detach()))
    return losses, first_grads


def leaf_norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v.to(torch.float64)))


def worst_leaf_gap(got: Dict[str, float], ref: Dict[str, float]) -> float:
    """max over leaves of |got - ref| / max(ref, the median leaf's ref)."""
    if not ref:
        return math.nan
    med = float(np.median(list(ref.values())))
    return max(abs(got[k] - ref[k]) / max(ref[k], med) for k in ref)
