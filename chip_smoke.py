#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. build   - compile every CUDA kernel from miso_tpu_torch/csrc with nvcc
               (sm_90a, one process per source, all at once) and the native
               geometry runtime with g++, and load them;
  2. kernels - hold each kernel to its plain PyTorch version on the card:
               * the fused interp+decode kernel at the ScanNet mapping widths
                 with 1e6 points (5 % out of bound), again with ignore_level
                 and padded storage with logical sizes, at an off-default
                 shape (3 levels, F=8, 3 hidden layers, out_dim 3) and at
                 base.yaml's (1 level, F=1, no hidden stack); the
                 autograd.Function's gradients against the plain version's;
               * the interp forward and grad kernels (grid and points'
                 gradients, and the grid's alone) at the ScanNet fine and
                 coarse levels, F=1, 12 and 36, 1e6 points; at the fine level
                 with all of them in one cell and all in 16^3 cells, and with
                 0 and 1 points; padded storage with a logical size at F=1, 4
                 and 12; their times (the grad's table-only and with the
                 points' gradient, the call and the device time of its
                 kernels) at both ScanNet levels with 1e6 points and at the
                 mesh path's levels with 2^15;
               * the decode kernel at 8->64->64->1, 8->64x3->3, 1->4->1 (also
                 without biases) and 12->128->128->17 with 1e6 points, and at
                 1e6 + 13, 1, 15 and 33 points; its registers, shared memory
                 and resident warps per SM; its times at 2^15, 2^18 and 1e6
                 points against the 3xTF32 tensor-core and FP32 bounds;
               * first- and second-order gradients through the interp and
                 decode autograd.Functions against the plain versions';
               * kernel, plain and library (grid_sample) times against the
                 bound of each at the ScanNet sizes;
               the kernels line takes the interp kernels' times at the ScanNet
               fine level (the grad's table only), and beside
               them the grad's with the points' gradient, as the
               default-decode step calls it, and its coarse-level call;
  3. main    - the mapping train step that bench.py drives, at full ScanNet
               width: GridNet (2 levels, F=4, 0.5 m / 0.1 m cells, 64x1
               decoder, 372 poses) with the default decode that bench.py and
               configs/ use (no decoder.impl key), mapping_loss with L1 SDF +
               free space, masked Adam, 4 rotating 1e6-point batches, 3
               warm-up and 20 timed steps, each launching the interp kernel
               twice (one per level), the interp grad kernel twice and the
               decode kernel once; then the same step with decoder.impl
               "pallas", one fused kernel launch per step, 3 warm-up and 10
               timed steps; in both, the first loss against a plain CPU copy
               of the model;
  4. mesh    - the synthetic mesh path at the ScanNet widths with the default
               decode: room_scene(4.0) -> Sdf3D -> GridTrainer (tsdf_loss_3d,
               autograd eikonal, 300 epochs) -> save_mesh (192^3 lattice,
               marching cubes) -> Chamfer / F-score, with every training step
               and lattice chunk launching the interp, interp grad and decode
               kernels; then those kernels held to their plain versions on
               the trained model at the path's shapes (a 2^15-point batch,
               2^15 eikonal points, a 2^18-point lattice chunk);
  5. report  - the card, step times, kernel times against the bound, and the
               kernels line (each kernel's launches: the interp, interp grad
               and decode kernels' in phase 3's default-decode run and phase
               4, the fused kernel's in phase 3's fused run); the last line
               is {"ok": true, "device": ...}.

Imports torch, numpy, scipy and miso_tpu_torch only.  Needs one CUDA card.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 1_000_000
WARMUP_STEPS = 3
TIMED_STEPS = 20
TIMED_CALLS = 20           # kernel / plain forward timings

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth.  The bound of a
# call is the larger of its operations over the peak of their type and its
# bytes over the bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# Values: float32 sums taken in another order than the plain version's
# (per-corner FMAs, MLP rows accumulated in registers) differ by a few ulp of
# the largest partial sum; 1e-4 absolute and relative leaves a wide margin.
VALUE_ATOL = 1e-4
VALUE_RTOL = 1e-4
# Gradients: both sides run the same torch-op recompute, but the scatter-add
# into the grids accumulates with atomics in a run-dependent order.
GRAD_RTOL_OF_MAX = 1e-4

# configs/rgbd/scannet.yaml's model, as bench.py:43-52 trains it: a free
# decoder (fix: false, no pretrained weights) on features drawn with
# init_stddev 1e-4, and no decoder.impl key, so GridNet's default decode.
SCANNET_MODEL = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
             "bound": [[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]],
             "base_cell_size": 0.5, "per_level_scale": 5.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None},
    "pose": {"optimize": False, "num_poses": 372},
}
# The same model on the fused kernel.
SCANNET_MODEL_FUSED = {**SCANNET_MODEL,
                       "decoder": {**SCANNET_MODEL["decoder"], "impl": "pallas"}}
FUSED_TIMED_STEPS = 10
# bench.py:72-73.
MAPPING_HYPER = dict(loss_type="L1", weight_sdf=1.0, weight_eik=0.0,
                     weight_fs=0.1, trunc_dist=0.15)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0]


def cuda_ms(fn, calls=TIMED_CALLS, warmup=3):
    """Mean device milliseconds per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _points(bound, n, gen, out_frac=0.05):
    """n points uniform in the bound; ``out_frac`` of them pushed outside it
    along a random axis by 1 cm to 1 m."""
    lo, hi = bound[:, 0], bound[:, 1]
    dev = bound.device
    x = lo + torch.rand((n, 3), generator=gen, device=dev) * (hi - lo)
    n_out = int(n * out_frac)
    axis = torch.randint(0, 3, (n_out,), generator=gen, device=dev)
    side = torch.randint(0, 2, (n_out,), generator=gen, device=dev).bool()
    push = 0.01 + 0.99 * torch.rand((n_out,), generator=gen, device=dev)
    rows = torch.arange(n_out, device=dev)
    x[rows, axis] = torch.where(side, hi[axis] + push, lo[axis] - push)
    return x.contiguous()


def _setup(bound_list, cell_sizes, fdim, hidden, hidden_layers, out_dim, n, seed):
    from miso_tpu_torch.ops.interp import grid_shape_for_bound
    from miso_tpu_torch.ops.mlp import mlp_init
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bound = torch.tensor(bound_list, dtype=torch.float32, device=dev)
    grids = [0.1 * torch.randn((*grid_shape_for_bound(bound, c), fdim),
                               generator=gen, device=dev) for c in cell_sizes]
    decoder = mlp_init(len(cell_sizes) * fdim, out_dim, hidden, hidden_layers,
                       generator=torch.Generator().manual_seed(seed), device=dev)
    return grids, _points(bound, n, gen), bound, decoder


def _max_err(got, ref):
    return float((got - ref).abs().max())


def _check_values(name, got, ref, errs):
    err = _max_err(got, ref)
    errs[name] = err
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(torch.allclose(got, ref, atol=VALUE_ATOL, rtol=VALUE_RTOL),
          f"{name}: max |kernel - plain| = {err:.3e} beyond atol {VALUE_ATOL}, "
          f"rtol {VALUE_RTOL}")
    log(f"  {name}: max |kernel - plain| = {err:.3e} (atol {VALUE_ATOL}, "
        f"rtol {VALUE_RTOL}) ok")


def _bound_ms(grids, x, decoder, out_dim):
    """Least time for one fused call: bytes (each input read once, the output
    written once) over HBM bandwidth vs FP32 operations over the FP32 peak."""
    n = x.shape[0]
    fdim = grids[0].shape[-1]
    nbytes = (x.numel() + n * out_dim + sum(g.numel() for g in grids)
              + sum(W.numel() + b.numel() for W, b in decoder)) * 4
    mlp_fma = sum(W.shape[0] * W.shape[1] for W, _ in decoder)
    lerp_fma = 8 * len(grids) * fdim
    return _bound(nbytes, 2.0 * (mlp_fma + lerp_fma) * n)


def _bound(nbytes, flops):
    """(ms, what bounds it): the larger of nbytes over the HBM bandwidth and
    flops over the FP32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels():
    from miso_tpu_torch.ops.fused_decode import (
        fused_interp_decode, fused_interp_decode_cuda, fused_interp_decode_plain)
    errs = {}
    g = SCANNET_MODEL["grid"]
    scannet_cells = [g["base_cell_size"] / g["per_level_scale"] ** l
                     for l in range(g["n_levels"])]
    grids, x, bound, decoder = _setup(g["bound"], scannet_cells, 4, 64, 1, 1,
                                      N_POINTS, seed=1)
    log(f"  ScanNet widths: grids {[tuple(t.shape) for t in grids]}, "
        f"MLP {[tuple(W.shape) for W, _ in decoder]}, {N_POINTS} points")
    with torch.no_grad():
        got = fused_interp_decode_cuda(grids, x, bound, decoder)
        ref = fused_interp_decode_plain(grids, x, bound, decoder)
        torch.cuda.synchronize()
        _check_values("scannet", got, ref, errs)

        # ignore_level on both levels, storage padded with garbage and logical
        # sizes: must equal the plain version on the same inputs, and zero
        # features (decoder of zeros) whatever the padding holds.
        gen = torch.Generator(device=x.device).manual_seed(2)
        padded, sizes = [], []
        for t in grids:
            sp = t.shape[:3]
            p = 10.0 * torch.randn((sp[0] + 3, sp[1] + 2, sp[2] + 1, t.shape[3]),
                                   generator=gen, device=x.device)
            p[:sp[0], :sp[1], :sp[2]] = t
            padded.append(p)
            sizes.append(torch.tensor(sp, dtype=torch.int32, device=x.device))
        ig = torch.tensor([0.0, 1.0], device=x.device)
        got = fused_interp_decode_cuda(padded, x, bound, decoder, sizes, ig)
        _check_values("scannet_sized_ignore[0,1]", got,
                      fused_interp_decode_plain(padded, x, bound, decoder, sizes, ig),
                      errs)
        _check_values("scannet_sized_vs_unpadded", got,
                      fused_interp_decode_plain(grids, x, bound, decoder, None, ig),
                      errs)
        ig = torch.tensor([1.0, 1.0], device=x.device)
        got = fused_interp_decode_cuda(padded, x, bound, decoder, sizes, ig)
        _check_values("scannet_sized_ignore[1,1]", got,
                      fused_interp_decode_plain(padded, x, bound, decoder, sizes, ig),
                      errs)

        # Off-default: 3 levels, F=8, 3 hidden layers (hidden_layers: 2), out 3.
        og, ox, ob, od = _setup(g["bound"], [0.4, 0.2, 0.1], 8, 64, 2, 3,
                                N_POINTS, seed=3)
        _check_values("3lvl_F8_h64x3_out3", fused_interp_decode_cuda(og, ox, ob, od),
                      fused_interp_decode_plain(og, ox, ob, od), errs)
        # configs/base.yaml: one level, F=1, hidden_layers 0 (1 -> 4 -> 1).
        bg, bx, bb, bd = _setup([[-1.0, 1.0]] * 3, [1.0], 1, 4, 0, 1,
                                N_POINTS, seed=4)
        _check_values("base_1lvl_F1", fused_interp_decode_cuda(bg, bx, bb, bd),
                      fused_interp_decode_plain(bg, bx, bb, bd), errs)

    # Gradients of the autograd.Function against the plain version's.
    cot = torch.randn((N_POINTS, 1), generator=torch.Generator(device=x.device)
                      .manual_seed(5), device=x.device)
    grad_err = {}
    results = []
    for fn in (fused_interp_decode, fused_interp_decode_plain):
        xs = x.clone().requires_grad_()
        gs = [t.clone().requires_grad_() for t in grids]
        ds = [(W.clone().requires_grad_(), b.clone().requires_grad_())
              for W, b in decoder]
        out = fn(gs, xs, bound, ds)
        flat = [t for pair in ds for t in pair]
        results.append(torch.autograd.grad((out * cot).sum(), [xs, *gs, *flat]))
    torch.cuda.synchronize()
    names = ["x"] + [f"grid{l}" for l in range(len(grids))] + [
        f"{'Wb'[i % 2]}{i // 2}" for i in range(2 * len(decoder))]
    for name, a, b in zip(names, *results):
        err = _max_err(a, b)
        scale = float(b.abs().max())
        grad_err[name] = err
        check(err <= GRAD_RTOL_OF_MAX * max(scale, 1e-6),
              f"grad {name}: max |function - plain| = {err:.3e}, max |plain| = "
              f"{scale:.3e}")
    log(f"  grads of the autograd.Function vs plain (max err, tol "
        f"{GRAD_RTOL_OF_MAX} x max|plain|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in grad_err.items()))
    errs["grad_max"] = max(grad_err.values())

    # Times at the ScanNet widths.
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_interp_decode_cuda(grids, x, bound, decoder))
        plain_ms = cuda_ms(lambda: fused_interp_decode_plain(grids, x, bound, decoder))
    bound_ms, bound_by = _bound_ms(grids, x, decoder, 1)
    log(f"  fused_interp_decode at ScanNet widths, {N_POINTS} points: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return errs, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _check_grad(name, got, ref, errs):
    """A gradient against its plain version: 1e-4 of the largest entry."""
    err = _max_err(got, ref)
    scale = float(ref.abs().max())
    errs[name] = err
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(err <= GRAD_RTOL_OF_MAX * max(scale, 1e-6),
          f"{name}: max |kernel - plain| = {err:.3e}, max |plain| = {scale:.3e}")
    log(f"  {name}: max |kernel - plain| = {err:.3e} (tol {GRAD_RTOL_OF_MAX} x "
        f"{scale:.3e}) ok")


def _grid_case(bound_list, cell, fdim, n, seed):
    from miso_tpu_torch.ops.interp import grid_shape_for_bound
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bound = torch.tensor(bound_list, dtype=torch.float32, device=dev)
    grid = 0.1 * torch.randn((*grid_shape_for_bound(bound, cell), fdim),
                             generator=gen, device=dev)
    return grid, _points(bound, n, gen), bound


def _grid_sample_inputs(grid, x, bound):
    """torch.nn.functional.grid_sample's arguments for the same function: the
    table as a (1, F, X, Y, Z) volume and the points normalised to [-1, 1] in
    (z, y, x) order (its last coordinate indexes the volume's last axis)."""
    from miso_tpu_torch.ops.interp import normalize_coordinates
    vol = grid.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    coords = normalize_coordinates(x, bound)[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3)
    return vol, coords.contiguous()


def _grid_sample(vol, coords):
    return torch.nn.functional.grid_sample(vol, coords, mode="bilinear",
                                           padding_mode="zeros", align_corners=False)


# The interp kernels' shapes on their paths, (name, bound, cell, points): the
# ScanNet levels at 1e6 points (bench.py's default-decode mapping step) and
# the synthetic mesh path's levels at 2^15 (its training batches;
# room_scene(4.0)'s bound, 0.1 m and 0.5 m cells).
MESH_BOUND = [[0.0, 5.0], [0.0, 5.0], [0.0, 2.65]]
INTERP_SHAPES = [
    ("scannet_fine", SCANNET_MODEL["grid"]["bound"], 0.1, N_POINTS),
    ("scannet_coarse", SCANNET_MODEL["grid"]["bound"], 0.5, N_POINTS),
    ("mesh_fine", MESH_BOUND, 0.1, 2 ** 15),
    ("mesh_coarse", MESH_BOUND, 0.5, 2 ** 15),
]


def _interp_bounds(grid, x, need_x):
    """(ms, what bounds it) of one interp grad call (or forward): x, the
    cotangent (or the output) and the table once each, plus, with the points'
    gradient, a read of the table and 12 B a point; 2 FMA a corner and
    feature, twice with the points' gradient."""
    n, fdim = x.shape[0], grid.shape[-1]
    nbytes = (x.numel() + n * fdim + grid.numel() + 6) * 4
    flops = 2.0 * 8 * fdim * n
    if need_x:
        nbytes += (grid.numel() + 3 * n) * 4
        flops *= 2
    return _bound(nbytes, flops)


def _interp_grad_check(name, grid, x, bound, size, errs, seed):
    """The grad kernel, with and without the points' gradient, against
    grid_interpolate_grad_plain."""
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    cot = torch.randn((x.shape[0], grid.shape[-1]), generator=gen, device=x.device)
    d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, cot, size)
    r_grid, r_x = grid_interpolate_grad_plain(grid, x, bound, cot, size)
    _check_grad(f"interp_grad_{name}_table", d_grid, r_grid, errs)
    check(d_x.shape == r_x.shape, f"interp_grad_{name}: points' gradient {tuple(d_x.shape)}")
    if x.shape[0]:
        _check_grad(f"interp_grad_{name}_points", d_x, r_x, errs)
    only, none = grid_interpolate_grad_cuda(grid, x, bound, cot, size, need_x=False)
    check(none is None, "need_x=False returned a points' gradient")
    _check_grad(f"interp_grad_{name}_table_only", only, r_grid, errs)


def phase_interp_kernels():
    """The interp forward and grad kernels against their plain versions, and
    their times at the shapes of their paths beside grid_sample's."""
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_grad_plain,
        grid_interpolate_plain, interp_grad_copies)
    errs = {}
    g = SCANNET_MODEL["grid"]
    fine_cell = g["base_cell_size"] / g["per_level_scale"]
    cases = [("fine_F4", g["bound"], fine_cell, 4),
             ("coarse_F4", g["bound"], g["base_cell_size"], 4),
             ("base_F1", [[-1.0, 1.0]] * 3, 1.0, 1),
             ("coarse_F12", g["bound"], g["base_cell_size"], 12),
             ("coarse_F36", g["bound"], g["base_cell_size"], 36)]
    dev = torch.device("cuda")
    with torch.no_grad():
        for seed, (name, bl, cell, fdim) in enumerate(cases, start=10):
            grid, x, bound = _grid_case(bl, cell, fdim, N_POINTS, seed)
            copies = interp_grad_copies(grid.shape[:3], fdim, N_POINTS)
            log(f"  interp {name}: grid {tuple(grid.shape)}, {N_POINTS} points, "
                f"grad kernel on {copies} copies of the table")
            _check_values(f"interp_{name}", grid_interpolate_cuda(grid, x, bound),
                          grid_interpolate_plain(grid, x, bound), errs)
            _interp_grad_check(name, grid, x, bound, None, errs, seed + 100)

        # The fine level again: all points in one cell, and all in 16^3 cells.
        grid, x, bound = _grid_case(g["bound"], fine_cell, 4, N_POINTS, 15)
        lo, ext = bound[:, 0], bound[:, 1] - bound[:, 0]
        dims = torch.tensor(grid.shape[:3], device=dev, dtype=torch.float32)
        u = torch.rand((N_POINTS, 3), generator=torch.Generator(device=dev).manual_seed(16),
                       device=dev)
        for name, cells in (("one_cell", (torch.tensor([50.0, 40.0, 15.0], device=dev) + 0.6
                                          + 0.8 * u) / dims),
                            ("dense_region", (24.0 + 16.0 * u) / dims)):
            _interp_grad_check(f"fine_{name}", grid, (lo + cells * ext).contiguous(), bound,
                               None, errs, 17)
        # No point and one point.
        for n in (0, 1):
            _interp_grad_check(f"fine_n{n}", grid, x[:n].contiguous(), bound, None, errs, 18)

        # Padded storage with a logical size, as the fused kernel takes it, at
        # F = 1 (scalar rows), 4 and 12: the forward against the plain version
        # on the unpadded grid, the grad against the plain one on the padding.
        for fdim in (1, 4, 12):
            grid, x, bound = _grid_case(g["bound"], g["base_cell_size"], fdim, N_POINTS,
                                        20 + fdim)
            padded = 10.0 * torch.randn((grid.shape[0] + 3, grid.shape[1] + 2,
                                         grid.shape[2] + 1, fdim), device=dev)
            padded[:grid.shape[0], :grid.shape[1], :grid.shape[2]] = grid
            size = torch.tensor(grid.shape[:3], dtype=torch.int32, device=dev)
            _check_values(f"interp_sized_F{fdim}_vs_unpadded",
                          grid_interpolate_cuda(padded, x, bound, size),
                          grid_interpolate_plain(grid, x, bound), errs)
            _interp_grad_check(f"coarse_sized_F{fdim}", padded, x, bound, size, errs,
                               40 + fdim)

    # Times at the shapes of the kernels' paths: the call by CUDA events (what
    # a caller waits for), the device time of all its kernels and memsets
    # (profiler); the plain version; grid_sample forward and backward.
    times = {}
    for seed, (name, bl, cell, n) in enumerate(INTERP_SHAPES, start=60):
        grid, x, bound = _grid_case(bl, cell, 4, n, seed)
        cot = torch.randn((n, 4), generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        vol, coords = _grid_sample_inputs(grid, x, bound)
        rec = {"grid": list(grid.shape), "points": n,
               "copies": interp_grad_copies(grid.shape[:3], 4, n)}
        with torch.no_grad():
            rec["fwd"] = dict(ms=cuda_ms(lambda: grid_interpolate_cuda(grid, x, bound)),
                              plain_ms=cuda_ms(lambda: grid_interpolate_plain(grid, x, bound)),
                              library_ms=cuda_ms(lambda: _grid_sample(vol, coords)))
            rec["fwd"]["bound_ms"], rec["fwd"]["bound_by"] = _interp_bounds(grid, x, False)
            for key, need_x in (("grad", False), ("grad_x", True)):
                call = lambda: grid_interpolate_grad_cuda(grid, x, bound, cot, need_x=need_x)
                rec[key] = dict(
                    ms=cuda_ms(call), device_ms=_kernel_device_ms(call),
                    plain_ms=cuda_ms(lambda: grid_interpolate_grad_plain(
                        grid, x, bound, cot, need_x=need_x)))
                rec[key]["bound_ms"], rec[key]["bound_by"] = _interp_bounds(grid, x, need_x)
        # grid_sample's backward: the table's gradient, and the points' too.
        vol_r = vol.clone().requires_grad_()
        coords_r = coords.clone().requires_grad_()
        out = _grid_sample(vol_r, coords_r)
        gout = cot.T.reshape(out.shape).contiguous()
        rec["grad"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, vol_r, gout, retain_graph=True))
        rec["grad_x"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, [vol_r, coords_r], gout, retain_graph=True))
        times[name] = rec
        log(f"  {name} {tuple(grid.shape)}, {n} points, grad on {rec['copies']} copies: " +
            "; ".join(f"{k} call {v['ms']:.4f} ms" +
                      (f" (device {v['device_ms']:.4f})" if "device_ms" in v else "") +
                      f", plain {v['plain_ms']:.4f}, grid_sample {v['library_ms']:.4f}, "
                      f"bound {v['bound_ms']:.4f} ({v['bound_by']})"
                      for k, v in ((k, rec[k]) for k in ("fwd", "grad", "grad_x"))))
    return errs, times

def _decode_bounds(params, n):
    """(ms, what bounds it) of one decode call of n points, and the FP32 SIMT
    bound beside it.  The kernel runs the hidden layers in 3xTF32 on the
    tensor cores (three TF32 products for each FP32 one, every width padded
    to 8) and an output layer of at most 4 columns in FP32 on the CUDA cores
    (k padded to 8): the least time is the larger of the two units' times
    and the bytes' (x read and the output written once, and the weights)."""
    fin, fout = params[0][0].shape[0], params[-1][0].shape[1]
    nbytes = (n * (fin + fout) + sum(W.numel() + (0 if b is None else b.numel())
                                     for W, b in params)) * 4
    mma_layers = params[:-1] if fout <= 4 else params
    padded = sum(-(-W.shape[0] // 8) * 8 * -(-W.shape[1] // 8) * 8 for W, _ in mma_layers)
    dot = -(-params[-1][0].shape[0] // 8) * 8 * fout if fout <= 4 else 0
    t_tc = 3 * 2.0 * padded * n / PEAK_TF32_FLOPS * 1e3
    t_dot = 2.0 * dot * n / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    tc = (max(t_tc, t_dot), "operations") if max(t_tc, t_dot) >= t_bytes else (t_bytes, "bytes")
    simt = _bound(nbytes, 2.0 * sum(W.shape[0] * W.shape[1] for W, _ in params) * n)
    return tc, simt


def _device_events(fn, calls=TIMED_CALLS):
    """(name, device microseconds) of every kernel and memset that ``calls``
    calls of fn ran under torch.profiler, after 3 calls of warm-up: the
    device's own time, without the host's launch cost in it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _kernel_device_ms(fn, kernel_name=None, calls=TIMED_CALLS):
    """Mean device milliseconds per launch of the kernels whose name contains
    ``kernel_name`` (or per call, of every kernel and memset fn runs, when
    None), over ``calls`` calls of fn (:func:`_device_events`)."""
    us = [t for name, t in _device_events(fn, calls)
          if kernel_name is None or kernel_name in name]
    check(len(us) == calls or (kernel_name is None and us),
          f"profiler saw {len(us)} {kernel_name} launches in {calls} calls")
    return sum(us) / calls / 1e3


def phase_decode_kernel():
    """The decode kernel against its plain version at the ScanNet decoder
    widths, off-default, widest and ragged shapes, and its times at a
    training batch, a lattice chunk and 1e6 points."""
    from miso_tpu_torch.ops.fused_decode import (mlp_decode_cuda, mlp_decode_occupancy,
                                                 mlp_decode_plain)
    from miso_tpu_torch.ops.mlp import mlp_init
    errs = {}
    dev = torch.device("cuda")

    def case(fin, fout, hidden, layers, n, seed):
        x = torch.randn((n, fin), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        return mlp_init(fin, fout, hidden, layers,
                        generator=torch.Generator().manual_seed(seed), device=dev), x

    # (name, F_in, out, hidden, hidden layers, points): the ScanNet decoder, an
    # off-default stack, base.yaml's, the widest layers with a ragged output
    # (3 levels x F=4 in, 128 hidden, 17 out), and ragged and tiny tiles.
    cases = [("scannet_8_64_64_1", 8, 1, 64, 1, N_POINTS),
             ("8_64x3_3", 8, 3, 64, 2, N_POINTS), ("base_1_4_1", 1, 1, 4, 0, N_POINTS),
             ("wide_12_128_128_17", 12, 17, 128, 1, N_POINTS)]
    cases += [(f"scannet_n{n}", 8, 1, 64, 1, n) for n in (N_POINTS + 13, 1, 15, 33)]
    cases += [(f"wide_n{n}", 12, 17, 128, 1, n) for n in (N_POINTS + 13, 1, 15, 33)]
    with torch.no_grad():
        for seed, (name, fin, fout, hidden, layers, n) in enumerate(cases, start=30):
            params, x = case(fin, fout, hidden, layers, n, seed)
            _check_values(f"decode_{name}", mlp_decode_cuda(params, x),
                          mlp_decode_plain(params, x), errs)
            if name == "base_1_4_1":
                nobias = tuple((W, None) for W, _ in params)
                _check_values("decode_base_no_bias", mlp_decode_cuda(nobias, x),
                              mlp_decode_plain(nobias, x), errs)

        # The occupancy of the kernels the ScanNet and widest decoders select
        # (their registers and spills are in phase 1's build report).
        occupancy = {}
        for name, fin, fout, hidden in (("scannet", 8, 1, 64), ("wide", 12, 17, 128)):
            params, x = case(fin, fout, hidden, 1, 1, 0)
            occ = mlp_decode_occupancy(params, x)
            occ["warps_per_sm"] = occ["blocks_per_sm"] * occ["threads"] // 32
            occupancy[name] = occ
            log(f"  decode kernel for the {name} decoder: {occ['threads']} threads and "
                f"{occ['smem_bytes']} B of dynamic shared memory per block (no static), "
                f"{occ['rows_per_warp']} points per warp tile, {occ['blocks_per_sm']} "
                f"resident blocks = {occ['warps_per_sm']} warps per SM")

        # Times at the ScanNet decoder widths: a training batch, a lattice
        # chunk and 1e6 points; ms is the wrapper's call by CUDA events (what a
        # caller waits for), device_ms the kernel alone (profiler).
        sizes = {}
        for n in (2 ** 15, 2 ** 18, N_POINTS):
            params, x = case(8, 1, 64, 1, n, 30)
            t = dict(ms=cuda_ms(lambda: mlp_decode_cuda(params, x)),
                     device_ms=_kernel_device_ms(lambda: mlp_decode_cuda(params, x),
                                                 "mlp_decode_kernel"),
                     plain_ms=cuda_ms(lambda: mlp_decode_plain(params, x)),
                     library_ms=None)
            (t["bound_ms"], t["bound_by"]), (t["fp32_bound_ms"], _) = _decode_bounds(params, n)
            sizes[n] = t
            log(f"  decode 8->64->64->1, {n} points: call {t['ms']:.4f} ms, kernel "
                f"{t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: 3xTF32 on the tensor cores); "
                f"FP32 SIMT bound {t['fp32_bound_ms']:.4f} ms")
    t = dict(sizes[N_POINTS], sizes={str(n): v for n, v in sizes.items()},
             occupancy=occupancy)
    return errs, t


def phase_function_grads():
    """First- and second-order gradients through _GridInterp and _MlpDecode
    against the plain versions', at a small size: the eikonal's shape, a
    spatial gradient taken with create_graph and then differentiated."""
    from miso_tpu_torch.ops.fused_decode import mlp_decode, mlp_decode_plain
    from miso_tpu_torch.ops.mlp import mlp_init
    from miso_tpu_torch.ops.tiled_interp import (
        _GridInterp, grid_interpolate_dispatch, grid_interpolate_grad_cuda,
        grid_interpolate_plain)
    errs = {}
    dev = torch.device("cuda")
    grid, x, bound = _grid_case(SCANNET_MODEL["grid"]["bound"], 0.5, 4, 4000, 40)
    params = mlp_init(4, 1, 32, 1, generator=torch.Generator().manual_seed(40),
                      device=dev)
    results = []
    for interp_fn, decode_fn in ((grid_interpolate_dispatch, mlp_decode),
                                 (grid_interpolate_plain, mlp_decode_plain)):
        xs = x.clone().requires_grad_()
        gs = grid.clone().requires_grad_()
        ps = [(W.clone().requires_grad_(), b.clone().requires_grad_())
              for W, b in params]
        out = decode_fn(ps, interp_fn(gs, xs, bound))
        (gx,) = torch.autograd.grad(out.sum(), xs, create_graph=True)
        eik = ((gx.norm(dim=-1) - 1.0) ** 2).mean()
        flat = [t for pair in ps for t in pair]
        before = (_GridInterp.recomputes, grid_interpolate_grad_cuda.launches)
        results.append(torch.autograd.grad((out ** 2).sum() + eik, [xs, gs, *flat]))
        if interp_fn is grid_interpolate_dispatch:
            check(_GridInterp.recomputes == before[0] and
                  grid_interpolate_grad_cuda.launches > before[1],
                  "the first-order backward did not run the grad kernel")
    torch.cuda.synchronize()
    names = ["x", "grid"] + [f"{'Wb'[i % 2]}{i // 2}" for i in range(2 * len(params))]
    for name, a, b in zip(names, *results):
        _check_grad(f"grad2_{name}", a, b, errs)
    return errs


# ---------------------------------------------------------------------------
# Phase 3: the main path (bench.py's default-decode step, then the fused one).
# ---------------------------------------------------------------------------

def mapping_batches(n, k, device):
    """k batches as bench.py:56-70 samples them (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(k):
        b = {
            "coords_frame": rng.uniform([0, 0, 0], [10.3, 8.7, 3.0], (n, 3)).astype(np.float32),
            "sample_frame_ids": rng.integers(0, 372, (n,)).astype(np.int32),
            "weights": np.ones((n, 1), np.float32),
            "sdf": rng.uniform(-0.15, 0.15, (n, 1)).astype(np.float32),
            "sdf_valid": (rng.uniform(size=(n, 1)) < 0.7).astype(np.float32),
            "sdf_signs": (rng.uniform(size=(n, 1)) < 0.2).astype(np.float32),
        }
        out.append({key: torch.from_numpy(v).to(device) for key, v in b.items()})
    return out


def kernel_counters():
    """Each kernel wrapper whose ``launches`` a path zeroes and reads."""
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda, mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_grad_cuda
    return {"interp": grid_interpolate_cuda, "interp_grad": grid_interpolate_grad_cuda,
            "decode": mlp_decode_cuda, "fused": fused_interp_decode_cuda}


def _zero_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp
    for fn in counters.values():
        fn.launches = 0
    _GridInterp.recomputes = 0


def _read_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp
    out = {k: fn.launches for k, fn in counters.items()}
    out["interp_recompute_backward"] = _GridInterp.recomputes
    return out


def run_mapping_steps(cfg, timed_steps, per_step):
    """bench.py's mapping train step on ``cfg`` for WARMUP_STEPS + timed_steps
    steps; each kernel must launch exactly ``per_step[name]`` times a step.
    Returns the step report."""
    from miso_tpu_torch.losses.common import total_loss
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    counters = kernel_counters()
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    batches = mapping_batches(N_POINTS, 4, dev)
    loss_fn = make_loss(mapping_loss, **MAPPING_HYPER)
    step = make_train_step(loss_fn, "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt_state = masked_adam_init(model)
    lr = 1e-3
    # The reference loss comes from the plain versions only: a CPU copy of the
    # model, whose every op (interp, decode) is plain PyTorch.
    plain_model = copy.deepcopy(model).cpu()
    plain_model.decode_impl = "xla"
    with torch.no_grad():
        plain_first = float(total_loss(loss_fn(
            plain_model, {k: v.cpu() for k, v in batches[0].items()}, None)))
    del plain_model
    torch.cuda.synchronize()

    n_steps = WARMUP_STEPS + timed_steps
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_steps)]
    losses = []
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(counters)
    t0 = time.perf_counter()
    for i in range(n_steps):
        events[i][0].record()
        model, opt_state, tl, _ = step(model, opt_state, batches[i % len(batches)],
                                       None, mask, lr)
        events[i][1].record()
        losses.append(tl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts(counters)
    losses = [float(v) for v in losses]
    step_ms = np.array([s.elapsed_time(e) for s, e in events[WARMUP_STEPS:]])

    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: first {losses[0]}, last {losses[-1]}")
    for name, per in {**per_step, "interp_recompute_backward": 0}.items():
        check(launches[name] == per * n_steps,
              f"{name}: {launches[name]} launches in {n_steps} steps; expected {per} per step")
    rel = abs(losses[0] - plain_first) / abs(plain_first)
    check(rel <= 1e-5, f"first step loss {losses[0]!r} vs the plain CPU model's "
          f"{plain_first!r}: relative difference {rel:.3e} > 1e-5")
    median = float(np.median(step_ms))
    report = dict(
        launches=launches, steps=n_steps, loss_first=losses[0], loss_last=losses[-1],
        loss_first_plain_cpu=plain_first, loss_first_rel_diff=rel,
        step_ms_median=median, step_ms_p10=float(np.percentile(step_ms, 10)),
        points_per_s=N_POINTS / (median * 1e-3), wall_s_all_steps=wall,
        wall_ms_per_step=wall * 1e3 / n_steps,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"  step {median:.3f} ms median, {report['step_ms_p10']:.3f} ms p10 (CUDA events), "
        f"{report['wall_ms_per_step']:.3f} ms of wall time a step; losses: first "
        f"{losses[0]:.6f} (plain CPU model {plain_first:.6f}, rel diff {rel:.2e}), last "
        f"{losses[-1]:.6f}; launches in {n_steps} steps {launches}")
    return report


def phase_main_path():
    """bench.py's step as bench.py and configs/ have it (the default decode:
    per step the interp kernel twice, the interp grad kernel twice, the decode
    kernel once), then the same step on the fused kernel (once per step)."""
    log("  default decode (bench.py, configs/):")
    default = run_mapping_steps(SCANNET_MODEL, TIMED_STEPS,
                                {"interp": 2, "interp_grad": 2, "decode": 1, "fused": 0})
    log("  decoder.impl \"pallas\" (the fused kernel):")
    fused = run_mapping_steps(SCANNET_MODEL_FUSED, FUSED_TIMED_STEPS,
                              {"interp": 0, "interp_grad": 0, "decode": 0, "fused": 1})
    return default, fused


# ---------------------------------------------------------------------------
# Phase 4: the synthetic mesh path (GridNet's default decode).
# ---------------------------------------------------------------------------

# The verify recipe at the ScanNet widths: 2 levels, F=4, 0.5 m / 0.1 m cells,
# 8 -> 64 -> 64 -> 1 decoder, no decoder.impl key (the default decode).
def mesh_model_cfg(bound):
    g = SCANNET_MODEL["grid"]
    return {
        "spatial_dim": 3,
        "grid": {**g, "bound": bound},
        "decoder": {k: v for k, v in SCANNET_MODEL["decoder"].items() if k != "impl"},
        "pose": {"optimize": False, "num_poses": 1},
    }


MESH_TRAIN = {"optimizer": "adam", "learning_rate": 5e-3, "epochs": 300,
              "max_epochs_in_level": 80, "grid_training_mode": "coordinate+joint"}
MESH_LOSS = dict(sdf_weight=3e3, sign_weight=1e2, eik_weight=5e1, trunc_dist=0.3)
MESH_BATCH = 2 ** 15            # SDF points per step; the eikonal draws as many
MESH_SAMPLES = 2 ** 18
MESH_RESOLUTION = 192           # 192^3 = 7.1e6 lattice points
MESH_CHUNK = 2 ** 18            # extract_fields' chunk
MESH_METRIC_POINTS = 100000
# tests/test_train_e2e.py:90-91.
MIN_FSCORE = 90.0
MAX_CHAMFER_L1_CM = 5.0


def _mesh_kernel_checks(model, ds):
    """The mesh path's three kernels against their plain versions on the
    trained model, at the path's own shapes: a 2^15-point training batch,
    2^15 eikonal points and a 2^18-point lattice chunk through the middle of
    the 192^3 lattice.  The grad kernel runs on the two sets that training
    differentiates."""
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_grad_plain,
        grid_interpolate_plain)
    from miso_tpu_torch.utils.sdf import lattice_chunk_points
    errs = {}
    bound = model.bound
    dev = bound.device
    gen = torch.Generator(device=dev).manual_seed(50)
    batch = torch.as_tensor(ds.sample(np.random.default_rng(50))["coords"], device=dev)
    eik = bound[:, 0] + torch.rand((MESH_BATCH, 3), generator=gen, device=dev) * (
        bound[:, 1] - bound[:, 0])
    lattice = lattice_chunk_points(bound, MESH_RESOLUTION,
                                   MESH_RESOLUTION ** 3 // 2 - MESH_CHUNK // 2, MESH_CHUNK)
    decoder = tuple((W.detach(), b.detach()) for W, b in model.decoder_params)
    with torch.no_grad():
        for name, x in (("batch", batch), ("eikonal", eik), ("lattice", lattice)):
            feats = []
            for level, param in enumerate(model.features):
                grid = param.detach()
                f = grid_interpolate_cuda(grid, x, bound)
                _check_values(f"mesh_interp_{name}_L{level}", f,
                              grid_interpolate_plain(grid, x, bound), errs)
                feats.append(f)
                if name == "lattice":
                    continue
                cot = torch.randn(f.shape, generator=gen, device=dev)
                d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, cot)
                r_grid, r_x = grid_interpolate_grad_plain(grid, x, bound, cot)
                _check_grad(f"mesh_grad_{name}_L{level}_table", d_grid, r_grid, errs)
                _check_grad(f"mesh_grad_{name}_L{level}_points", d_x, r_x, errs)
            feats = torch.cat(feats, dim=-1)
            _check_values(f"mesh_decode_{name}", mlp_decode_cuda(decoder, feats),
                          mlp_decode_plain(decoder, feats), errs)
    return errs


def phase_mesh():
    """room_scene(4.0) -> Sdf3D -> GridTrainer (tsdf_loss_3d, autograd
    eikonal) -> save_mesh (lattice SDF, marching cubes) -> Chamfer / F-score.
    Every training step and lattice chunk must launch the interp, interp
    grad and decode kernels; then the kernels are held to their plain
    versions on the trained model at the path's shapes."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh, marching_cubes
    from miso_tpu_torch.train.trainer import GridTrainer
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import extract_fields, save_mesh

    counters = kernel_counters()

    t0 = time.perf_counter()
    verts, tris = room_scene(4.0)
    scene = TriangleMesh(verts, tris)
    ds = Sdf3D(scene, batch_size=MESH_BATCH, total_samples=MESH_SAMPLES, trunc_dist=0.3)
    data_s = time.perf_counter() - t0
    model = create_grid_net(mesh_model_cfg(ds.bound.tolist()),
                            generator=torch.Generator().manual_seed(0))
    check(model.decode_impl == "xla", "the mesh path runs the default decode")
    log(f"  scene: {len(verts)} vertices, {len(tris)} triangles; {MESH_SAMPLES} SDF "
        f"samples in {data_s:.2f} s; grids {[tuple(f.shape) for f in model.features]}")
    trainer = GridTrainer(MESH_TRAIN, model, make_loss(tsdf_loss_3d, **MESH_LOSS), ds)

    # Time each step by CUDA events around the trainer's own step function.
    step_fn = trainer.step_fn
    events, totals = [], []

    def timed_step(*args):
        events.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        out = step_fn(*args)
        events[-1][1].record()
        totals.append(out[2])
        return out

    trainer.step_fn = timed_step
    epochs = MESH_TRAIN["epochs"]
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    model = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = _read_counts(counters)
    losses = [float(v) for v in totals]
    check(len(losses) == epochs, f"{len(losses)} steps for {epochs} epochs")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], f"loss did not fall: first {losses[0]}, last {losses[-1]}")
    step_ms = np.array([s.elapsed_time(e) for s, e in events])
    levels = model.num_levels
    log(f"  training: {epochs} epochs in {train_s:.2f} s ({epochs / train_s:.1f} "
        f"epochs/s); step {np.median(step_ms):.3f} ms median, "
        f"{np.percentile(step_ms, 10):.3f} ms p10; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {train_counts}")

    # The mesh through the user's entry point, counted; then its two stages
    # again, timed apart.
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    mesh = save_mesh(model, model.bound, None, resolution=MESH_RESOLUTION)
    mesh_s = time.perf_counter() - t0
    lattice_counts = _read_counts(counters)
    chunks = -(-MESH_RESOLUTION ** 3 // MESH_CHUNK)
    check(len(mesh.vertices) > 1000, f"marching cubes gave {len(mesh.vertices)} vertices")
    b = ds.bound.astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = extract_fields(model, b, MESH_RESOLUTION, chunk=MESH_CHUNK)
    lattice_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    marching_cubes(field, 0.0, origin=b[:, 0],
                   spacing=(b[:, 1] - b[:, 0]) / (MESH_RESOLUTION - 1.0))
    mc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = mesh_reconstruction_metrics(mesh, scene, n_points=MESH_METRIC_POINTS)
    metrics_s = time.perf_counter() - t0
    log(f"  save_mesh at {MESH_RESOLUTION}^3 = {MESH_RESOLUTION ** 3} points ({chunks} "
        f"chunks): {mesh_s:.3f} s, {len(mesh.vertices)} vertices, "
        f"{len(mesh.triangles)} triangles; launches {lattice_counts}; apart: lattice "
        f"{lattice_s:.3f} s, marching cubes {mc_s:.3f} s; metrics {metrics_s:.2f} s")
    log("  metrics: " + ", ".join(f"{k} {v:.3f}" for k, v in metrics.items()))
    check(metrics["F-score (%)"] > MIN_FSCORE, f"F-score {metrics['F-score (%)']:.2f} "
          f"% not above {MIN_FSCORE}")
    check(metrics["Chamfer_L1 (cm)"] < MAX_CHAMFER_L1_CM,
          f"Chamfer_L1 {metrics['Chamfer_L1 (cm)']:.3f} cm not below {MAX_CHAMFER_L1_CM}")
    per_step = {"interp": 2 * levels, "interp_grad": levels, "decode": 2}
    for name, least in per_step.items():
        check(train_counts[name] >= least * epochs,
              f"{name}: {train_counts[name]} launches in {epochs} steps, expected "
              f">= {least} per step")
    per_chunk = {"interp": levels, "decode": 1}
    for name, least in per_chunk.items():
        check(lattice_counts[name] >= least * chunks,
              f"{name}: {lattice_counts[name]} launches in {chunks} lattice chunks, "
              f"expected >= {least} per chunk")
    check(train_counts["fused"] == 0 and lattice_counts["fused"] == 0,
          "the default decode must not run the fused kernel")

    log("  the mesh path's kernels against their plain versions on the trained model:")
    kernel_errs = _mesh_kernel_checks(model, ds)
    return dict(
        epochs=epochs, train_s=train_s, epochs_per_s=epochs / train_s,
        step_ms_median=float(np.median(step_ms)),
        step_ms_p10=float(np.percentile(step_ms, 10)),
        loss_first=losses[0], loss_last=losses[-1], train_launches=train_counts,
        resolution=MESH_RESOLUTION, lattice_points=MESH_RESOLUTION ** 3,
        lattice_chunks=chunks, save_mesh_s=mesh_s, lattice_launches=lattice_counts,
        lattice_s=lattice_s, marching_cubes_s=mc_s, mesh_vertices=len(mesh.vertices),
        mesh_triangles=len(mesh.triangles), metrics=metrics), kernel_errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from miso_tpu_torch import native
    from miso_tpu_torch.ops import _build
    from miso_tpu_torch.ops.fused_decode import _library
    from miso_tpu_torch.ops.tiled_interp import _library as _interp_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    log("phase 1: build")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    _library()
    _library("mlp_decode")
    _interp_library()
    t1 = time.perf_counter()
    native.build()
    native_s = time.perf_counter() - t1
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        log(f"  {name}: nvcc {seconds[name]:.1f} s")
        report_log = _build.BUILD_DIR / f"{name}.log"
        if report_log.exists():
            for line in report_log.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
    log(f"  native runtime (g++): {native_s:.1f} s; build and load: {build_s:.1f} s")

    log("phase 2: kernels against their plain versions")
    errs, times = phase_kernels()
    interp_errs, interp_times = phase_interp_kernels()
    decode_errs, decode_t = phase_decode_kernel()
    grad2_errs = phase_function_grads()
    errs.update(interp_errs)
    errs.update(decode_errs)
    errs.update(grad2_errs)

    log("phase 3: main path (bench.py's mapping train step: default decode, then fused)")
    main_report, fused_report = phase_main_path()

    log("phase 4: synthetic mesh path (default decode)")
    mesh_report, mesh_errs = phase_mesh()
    errs.update(mesh_errs)

    log("phase 5: report")
    print(json.dumps({"card": card, "build_s": build_s, "max_abs_err": errs,
                      "interp_kernels": interp_times, "decode_kernel": decode_t,
                      "main_path": main_report, "main_path_fused": fused_report,
                      "mesh_path": mesh_report}), flush=True)

    def launches(name):
        """The launches on the paths that run the kernel: phase 3's
        default-decode run and phase 4's training and lattice."""
        return (main_report["launches"][name] + mesh_report["train_launches"][name]
                + mesh_report["lattice_launches"][name])

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    def worst(*prefixes):
        """The largest error of a kernel's checks at its paths' shapes: the
        ScanNet widths of phase 2 and the mesh path's own of phase 4."""
        return max(v for k, v in errs.items() if k.startswith(prefixes))

    fine, coarse = interp_times["scannet_fine"], interp_times["scannet_coarse"]
    # The grad kernel's entry: the fine level's table-only call; beside it the
    # call with the points' gradient (the default-decode step's) and the
    # coarse level's table-only call, which spreads its atomics over copies.
    backward = entry("grid_interp_backward", "miso_tpu_torch/csrc/grid_interp.cu",
                     "miso_tpu/ops/pallas_interp.py:268", launches("interp_grad"),
                     worst("interp_grad_fine_F4", "interp_grad_coarse_F4", "mesh_grad_"),
                     fine["grad"])
    backward.update(points_grad_ms=fine["grad_x"]["ms"],
                    points_grad_bound_ms=fine["grad_x"]["bound_ms"],
                    coarse_ms=coarse["grad"]["ms"], coarse_bound_ms=coarse["grad"]["bound_ms"],
                    coarse_copies=coarse["copies"])
    kernels = [
        entry("fused_interp_decode", "miso_tpu_torch/csrc/fused_interp_decode.cu",
              "miso_tpu/ops/pallas_decode.py:186", fused_report["launches"]["fused"],
              errs["scannet"], times),
        entry("grid_interp_forward", "miso_tpu_torch/csrc/grid_interp.cu",
              "miso_tpu/ops/pallas_interp.py:196", launches("interp"),
              worst("interp_fine_F4", "interp_coarse_F4", "mesh_interp_"), fine["fwd"]),
        backward,
        entry("mlp_decode", "miso_tpu_torch/csrc/mlp_decode.cu",
              "miso_tpu/ops/pallas_decode.py:107", launches("decode"),
              worst("decode_scannet", "mesh_decode_"), decode_t),
    ]
    tpu_kernels = [
        {"replaces": "miso_tpu/ops/pallas_decode.py:186", "name": "_fused_kernel",
         "status": "ported and checked", "port": "fused_interp_decode"},
        {"replaces": "miso_tpu/ops/pallas_decode.py:107", "name": "_decode_kernel",
         "status": "ported and checked", "port": "mlp_decode"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:196", "name": "_interp_kernel",
         "status": "ported and checked", "port": "grid_interp_forward"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:268", "name": "_interp_grad_kernel",
         "status": "ported and checked", "port": "grid_interp_backward"},
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps({"tpu_kernels": tpu_kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
