"""Operations and bytes of the mapping step's kernels, from shapes and from
the rows the points touch, and the least time the card needs for them.

A least time is the larger of the operations over the peak of the unit that
can run them at float32 accuracy and the bytes over the HBM bandwidth.  Each
input byte counts once and each output byte once, whatever a kernel reads
again; a table counts the rows that the points touch, not its size, since
that is what these inputs need.  The peaks are ``peaks.json``'s published
ones.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import torch

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "peaks.json")))


def least_s(flops_simt: float = 0.0, flops_tensor: float = 0.0, nbytes: float = 0.0) -> float:
    """Least seconds: FP32 operations on the CUDA cores plus float32-accurate
    matrix products on the tensor cores, or the bytes, whichever is longer."""
    t_ops = flops_simt / PEAKS["fp32_flops"] + flops_tensor / PEAKS["fp32_exact_tensor_flops"]
    return max(t_ops, nbytes / PEAKS["hbm_bytes_per_s"])


def touched_rows(x: torch.Tensor, bound: torch.Tensor, dims: Sequence[int]) -> int:
    """Distinct table rows that the 8 corners of the points inside the table
    read (corners beyond the table read nothing)."""
    lo, hi = bound[:, 0], bound[:, 1]
    n = torch.tensor([float(d) for d in dims], dtype=x.dtype, device=x.device)
    i0 = torch.floor((x - lo) / (hi - lo) * n - 0.5).to(torch.int64)
    rows = []
    for c in range(8):
        ik = i0 + torch.tensor([(c >> 2) & 1, (c >> 1) & 1, c & 1], device=x.device)
        ok = ((ik >= 0) & (ik < torch.tensor(list(dims), device=x.device))).all(-1)
        ik = ik[ok]
        rows.append((ik[:, 0] * dims[1] + ik[:, 1]) * dims[2] + ik[:, 2])
    return int(torch.unique(torch.cat(rows)).numel())


def interp_forward(n: int, fdim: int, rows: int, elem: int = 4) -> Dict[str, float]:
    """One level's read of n points: the points and the touched rows in, the
    features out; 8 corners of F multiply-adds a point."""
    return dict(flops_simt=2.0 * 8 * fdim * n,
                nbytes=12.0 * n + rows * fdim * elem + 4.0 * n * fdim)


def interp_backward(n: int, fdim: int, table_rows: int, rows: int, need_x: bool,
                    elem: int = 4) -> Dict[str, float]:
    """One level's backward: the points and the features' cotangent in, the
    table's dense gradient out; with the points' gradient also the touched
    rows in and 12 bytes a point out, and twice the multiply-adds."""
    flops = 2.0 * 8 * fdim * n
    nbytes = 12.0 * n + 4.0 * n * fdim + table_rows * fdim * 4.0
    if need_x:
        flops *= 2
        nbytes += rows * fdim * elem + 12.0 * n
    return dict(flops_simt=flops, nbytes=nbytes)


def mlp_macs(dims: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def decode_forward(n: int, dims: Sequence[int]) -> Dict[str, float]:
    """The decoder on n points: its products on the tensor cores; the inputs
    in, the outputs out, the weights in."""
    weights = mlp_macs(dims) + sum(dims[1:])
    return dict(flops_tensor=2.0 * n * mlp_macs(dims),
                nbytes=4.0 * (n * (dims[0] + dims[-1]) + weights))


def decode_backward(n: int, dims: Sequence[int], weight_grads: bool) -> Dict[str, float]:
    """The decoder's backward: the inputs' gradient (every layer's product
    with its transposed weights), and the weights' where they train; the
    inputs and the output's cotangent in, the inputs' gradient out."""
    macs = mlp_macs(dims) * (2 if weight_grads else 1)
    weights = mlp_macs(dims) + sum(dims[1:])
    return dict(flops_tensor=2.0 * n * macs,
                nbytes=4.0 * (n * (2 * dims[0] + dims[-1]) + weights
                              * (2 if weight_grads else 1)))


def add(*counts: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0.0) + v
    return out
