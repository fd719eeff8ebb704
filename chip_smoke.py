#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. build   - compile every CUDA kernel from miso_tpu_torch/csrc with nvcc
               (sm_90a, one process per source, all at once) and the native
               geometry runtime with g++, and load them;
  2. kernels - hold each kernel to its plain PyTorch version on the card:
               * the fused interp+decode kernel at the ScanNet mapping widths
                 with 1e6 points (5 % out of bound), with a point on a cell
                 face, with ignore_level and padded storage with logical
                 sizes, at an off-default shape (3 levels, F=8, 3 hidden
                 layers, out_dim 3), at base.yaml's (1 level, F=1, no hidden
                 stack), at F=1, 12 and 36, with the mesh path's padded levels
                 staged in shared memory, and with a table just under and
                 just over the staging budget (each case logs which levels it
                 staged); the autograd.Function's gradients against the plain
                 version's; its call and kernel time against its 3xTF32 and
                 FP32 bounds and the sum of the kernels it fuses;
               * the interp forward and grad kernels (grid and points'
                 gradients, and the grid's alone) at the ScanNet fine and
                 coarse levels, F=1, 12 and 36, 1e6 points; at the fine level
                 with all of them in one cell and all in 16^3 cells, and with
                 0 and 1 points; padded storage with a logical size at F=1, 4
                 and 12; the forward with a table just under and just over its
                 staging budget (each case logs the forward's path, shared
                 memory or L2); their times (the grad's table-only and with the
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
               fine level (the grad's table only), and beside them the
               forward's coarse-level call and paths, the grad's call with the
               points' gradient, as the default-decode step calls it, and its
               coarse-level call;
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
               2^15 eikonal points, a 2^18-point lattice chunk), and the interp
               forward's times on the lattice chunk;
  5. slam    - demo/full_slam_scannet.py --synthetic through the port's
               entry points: room_scene(5.0) and the demo's 24-frame orbit
               simulated by SdfSequence, configs/rgbd/scannet.yaml through
               load_config with the demo's overrides (13 m cube, 0.5 m / 0.1
               m cells, 8 -> 32 -> 32 -> 1 decoder pretrained on the scene for
               200 epochs, saved with save_pytree, loaded as the config's
               pretrained_model and fixed), then SubmapSlam: the 50-iteration
               init burst, and per frame odometry, Adam tracking (15
               iterations) and a 15-iteration mapping burst drawn on the card
               from the resident pool; ATE and rotation RMSE after Umeyama
               alignment, beside the odometry-only trajectory's, which it
               must beat, and under 3 cm; track and map ms per frame.  Then
               the LM run (tests/test_slam.py's recipe): a grid trained on
               keyframes 0-7, keyframe 5 perturbed, Tracker.track_lm with
               configs/lidar/ncd_quad.yaml's tracking settings, which must
               halve the translation error and end under 1.72 degrees.
               Launches exact in both runs (per LM iteration 2 interp
               forwards, 2 points-only interp backwards, 1 decode); the
               kernels against their plain versions at the path's shapes, and
               the points-only backward at 4096 points and at 1e6 points on
               the ScanNet levels, timed beside the table-and-points call;
  6. report  - the card, step times, kernel times against the bound, and the
               kernels line (each kernel's launches: the interp, interp grad
               and decode kernels' in phase 3's default-decode run, phase 4
               and phase 5, the points-only backward's in phase 5's LM run,
               the fused kernel's in phase 3's fused run); the last line is
               {"ok": true, "device": ...}.

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
MARK_CYCLES = 10_000       # a profiler window's spin-kernel markers, ~5 us

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
    return float((got - ref).detach().abs().max()) if got.numel() else 0.0


def _check_values(name, got, ref, errs):
    err = _max_err(got, ref)
    errs[name] = err
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(torch.allclose(got, ref, atol=VALUE_ATOL, rtol=VALUE_RTOL),
          f"{name}: max |kernel - plain| = {err:.3e} beyond atol {VALUE_ATOL}, "
          f"rtol {VALUE_RTOL}")
    log(f"  {name}: max |kernel - plain| = {err:.3e} (atol {VALUE_ATOL}, "
        f"rtol {VALUE_RTOL}) ok")


def _fused_bounds(grids, x, decoder):
    """(ms, what bounds it) of one fused call, and the FP32 bound beside it.
    The kernel runs the MLP as the decode kernel does (3xTF32 hidden layers,
    an output layer of at most 4 columns in FP32) and the lerp in FP32 on the
    CUDA cores: its least time is the larger of the two units' times and the
    bytes' (x read and the output written once, every table and the
    weights).  The FP32 bound counts every FMA on the CUDA cores."""
    n = x.shape[0]
    fdim = grids[0].shape[-1]
    t_tc, t_dot = _mlp_op_ms(decoder, n)
    lerp_flops = 2.0 * 8 * len(grids) * fdim * n
    t_ops = max(t_tc, t_dot + lerp_flops / PEAK_FP32_FLOPS * 1e3)
    nbytes = (x.numel() + n * decoder[-1][0].shape[1] + sum(g.numel() for g in grids)
              + sum(W.numel() + b.numel() for W, b in decoder)) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    tc = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    mlp_fma = sum(W.shape[0] * W.shape[1] for W, _ in decoder)
    return tc, _bound(nbytes, 2.0 * mlp_fma * n + lerp_flops)


def _bound(nbytes, flops):
    """(ms, what bounds it): the larger of nbytes over the HBM bandwidth and
    flops over the FP32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _shaped_case(shape, n, seed, bound_list=((-1.0, 1.0), (-1.0, 1.2), (-0.8, 1.0))):
    """A (X, Y, Z, F) table of the given shape and n points 5 % beyond a bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bound = torch.tensor(bound_list, dtype=torch.float32, device=dev)
    return (0.1 * torch.randn(shape, generator=gen, device=dev), _points(bound, n, gen),
            bound)


def _pad(grids, seed):
    """Each grid in storage padded with garbage, and its logical size."""
    gen = torch.Generator(device=grids[0].device).manual_seed(seed)
    padded, sizes = [], []
    for t in grids:
        sp = t.shape[:3]
        p = 10.0 * torch.randn((sp[0] + 3, sp[1] + 2, sp[2] + 1, t.shape[3]),
                               generator=gen, device=t.device)
        p[:sp[0], :sp[1], :sp[2]] = t
        padded.append(p)
        sizes.append(torch.tensor(sp, dtype=torch.int32, device=t.device))
    return padded, sizes


# A point of the ScanNet coarse level exactly on a cell face: u = 16 on axis 1
# when rounded op by op (15.99999 through a fused multiply-add).
ON_FACE = [1.4275164604187012, 8.010832786560059, 0.1370464414358139]


def _fused_check(name, args, errs):
    """The fused kernel against its plain version on the same inputs; logs
    which levels it staged in shared memory."""
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_occupancy,
                                                 fused_interp_decode_plain)
    occ = fused_interp_decode_occupancy(*args)
    log(f"  fused {name}: grids {[tuple(t.shape) for t in args[0]]}, levels staged "
        f"{occ['staged']}, {occ['smem_bytes']} B of shared memory a block, "
        f"{occ['blocks_per_sm']} blocks an SM")
    _check_values(f"fused_{name}", fused_interp_decode_cuda(*args),
                  fused_interp_decode_plain(*args), errs)
    return occ


def phase_kernels():
    from miso_tpu_torch.ops.fused_decode import (
        FUSED_BLOCKS_PER_SM, fused_interp_decode, fused_interp_decode_cuda,
        fused_interp_decode_plain, fused_layout, mlp_decode_cuda)
    from miso_tpu_torch.ops.mlp import mlp_init
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, smem_budget
    errs = {}
    g = SCANNET_MODEL["grid"]
    scannet_cells = [g["base_cell_size"] / g["per_level_scale"] ** l
                     for l in range(g["n_levels"])]
    grids, x, bound, decoder = _setup(g["bound"], scannet_cells, 4, 64, 1, 1,
                                      N_POINTS, seed=1)
    log(f"  ScanNet widths: grids {[tuple(t.shape) for t in grids]}, "
        f"MLP {[tuple(W.shape) for W, _ in decoder]}, {N_POINTS} points")
    dev = x.device
    with torch.no_grad():
        occ = _fused_check("scannet", (grids, x, bound, decoder), errs)
        # A point on a cell face of the coarse level, which the kernel must
        # put in the cell the plain version does.
        xf = x[:20000].clone()
        xf[0] = torch.tensor(ON_FACE, device=dev)
        _fused_check("scannet_on_face", (grids, xf, bound, decoder), errs)

        # ignore_level on both levels, storage padded with garbage and logical
        # sizes: must equal the plain version on the same inputs, and zero
        # features (decoder of zeros) whatever the padding holds.
        padded, sizes = _pad(grids, 2)
        ig = torch.tensor([0.0, 1.0], device=dev)
        _fused_check("scannet_sized_ignore[0,1]", (padded, x, bound, decoder, sizes, ig), errs)
        _check_values("fused_scannet_sized_vs_unpadded",
                      fused_interp_decode_cuda(padded, x, bound, decoder, sizes, ig),
                      fused_interp_decode_plain(grids, x, bound, decoder, None, ig), errs)
        ig = torch.tensor([1.0, 1.0], device=dev)
        _fused_check("scannet_sized_ignore[1,1]", (padded, x, bound, decoder, sizes, ig), errs)

        # Off-default: 3 levels, F=8, 3 hidden layers (hidden_layers: 2), out 3.
        _fused_check("3lvl_F8_h64x3_out3",
                     _setup(g["bound"], [0.4, 0.2, 0.1], 8, 64, 2, 3, N_POINTS, seed=3), errs)
        # configs/base.yaml: one level, F=1, hidden_layers 0 (1 -> 4 -> 1).
        _fused_check("base_1lvl_F1",
                     _setup([[-1.0, 1.0]] * 3, [1.0], 1, 4, 0, 1, N_POINTS, seed=4), errs)
        # F = 1, 12 and 36 at the ScanNet cells: the coarse table is staged
        # at F = 1 and left in L2 at F = 12 and 36 (L * F = 24, 72 wide).
        for fdim in (1, 12, 36):
            _fused_check(f"scannet_F{fdim}",
                         _setup(g["bound"], scannet_cells, fdim, 64, 1, 1, N_POINTS,
                                seed=5 + fdim), errs)
        # Padded storage with logical sizes on the staged path: the mesh path's
        # levels, both small enough to stage in their padding.
        mg, mx, mb, md = _setup(MESH_BOUND, [0.5, 1.0], 4, 64, 1, 1, N_POINTS, seed=6)
        mp, ms = _pad(mg, 7)
        occ_sized = _fused_check("mesh_sized_staged", (mp, mx, mb, md, ms), errs)
        check(all(occ_sized["staged"]), f"padded mesh levels not staged: {occ_sized}")
        _check_values("fused_mesh_sized_vs_unpadded", fused_interp_decode_cuda(mp, mx, mb, md, ms),
                      fused_interp_decode_plain(mg, mx, mb, md), errs)
        # One level just under and just over the block's staging budget at
        # the ScanNet decoder (8 -> 64 -> 64 -> 1 after a second level of 1 row).
        other = fused_layout([8, 64, 64, 1], [])["smem_bytes"] + 16
        rows = (smem_budget(FUSED_BLOCKS_PER_SM) - other) // 16
        dec = mlp_init(8, 1, 64, 1, generator=torch.Generator().manual_seed(9), device=dev)
        for name, r in (("budget_under", rows), ("budget_over", rows + 1)):
            t, xb, bb = _shaped_case((1, 1, r, 4), N_POINTS, 8)
            tiny = 0.1 * torch.randn((1, 1, 1, 4), device=dev)
            occ_b = _fused_check(name, ([t, tiny], xb, bb, dec), errs)
            check(occ_b["staged"] == [name == "budget_under", True],
                  f"{name}: levels staged {occ_b['staged']}")

    # Gradients of the autograd.Function against the plain version's.
    cot = torch.randn((N_POINTS, 1), generator=torch.Generator(device=dev)
                      .manual_seed(5), device=dev)
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

    # Times at the ScanNet widths: the call (CUDA events), the kernel alone
    # (profiler), and beside it, in the same call, the parts it fuses as
    # GridNet's default decode runs them: the interp forward at both levels
    # and the decode kernel (device time of each).
    with torch.no_grad():
        call = lambda: fused_interp_decode_cuda(grids, x, bound, decoder)  # noqa: E731
        t = dict(ms=cuda_ms(call), device_ms=_kernel_device_ms(call, "fused_interp_decode"),
                 plain_ms=cuda_ms(lambda: fused_interp_decode_plain(grids, x, bound, decoder)),
                 library_ms=None)
        feats = torch.cat([grid_interpolate_cuda(lv, x, bound) for lv in grids], dim=-1)
        parts = {f"interp_L{l}": _kernel_device_ms(lambda lv=lv: grid_interpolate_cuda(lv, x, bound))
                 for l, lv in enumerate(grids)}
        parts["decode"] = _kernel_device_ms(lambda: mlp_decode_cuda(decoder, feats),
                                            "mlp_decode_kernel")
    (t["bound_ms"], t["bound_by"]), (t["fp32_bound_ms"], _) = _fused_bounds(grids, x, decoder)
    t.update(parts_device_ms=parts, parts_sum_ms=sum(parts.values()),
             levels_staged=occ["staged"], smem_bytes=occ["smem_bytes"],
             blocks_per_sm=occ["blocks_per_sm"])
    log(f"  fused_interp_decode at ScanNet widths, {N_POINTS} points: call {t['ms']:.4f} ms, "
        f"kernel {t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}: 3xTF32 on the tensor cores), FP32 bound "
        f"{t['fp32_bound_ms']:.4f} ms; its parts as kernels: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f", sum {t['parts_sum_ms']:.4f} ms")
    return errs, t


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


def _fwd_path(grid, n):
    """The interp forward's path for n points on a grid (float4 rows when
    F % 4 == 0: the cases' tensors are 16-byte aligned)."""
    from miso_tpu_torch.ops.tiled_interp import interp_forward_path
    return interp_forward_path(grid, n, grid.shape[-1] % 4 == 0)


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
        INTERP_STAGED_BLOCKS, grid_interpolate_cuda, grid_interpolate_grad_cuda,
        grid_interpolate_grad_plain, grid_interpolate_plain, interp_grad_copies, smem_budget,
        table_bytes)
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
            log(f"  interp {name}: grid {tuple(grid.shape)}, {N_POINTS} points, forward "
                f"path {_fwd_path(grid, N_POINTS)}, grad kernel on {copies} copies of the table")
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
            _check_values(f"interp_fine_n{n}", grid_interpolate_cuda(grid, x[:n].contiguous(),
                                                                     bound),
                          grid_interpolate_plain(grid, x[:n].contiguous(), bound), errs)

        # A table just under and just over the forward's staging budget (F = 4):
        # in shared memory, and in pairs from L2.
        rows = smem_budget(INTERP_STAGED_BLOCKS) // 16
        for name, z in (("budget_under", rows // 64), ("budget_over", rows // 64 + 1)):
            grid, x, bound = _shaped_case((8, 8, z, 4), N_POINTS, 19)
            got = _fwd_path(grid, N_POINTS)
            check(got == ("staged" if name == "budget_under" else "pairs"),
                  f"interp {name}: {table_bytes(grid)} B taken {got}")
            log(f"  interp {name}: grid {tuple(grid.shape)} ({table_bytes(grid)} B), forward "
                f"path {got}")
            _check_values(f"interp_{name}", grid_interpolate_cuda(grid, x, bound),
                          grid_interpolate_plain(grid, x, bound), errs)

        # Padded storage with a logical size, as the fused kernel takes it, at
        # F = 1 (scalar rows), 4 and 12 at the coarse level (staged, staged,
        # L2) and F = 4 at the fine one (pairs): the forward against the plain
        # version on the unpadded grid, the grad against the plain one on the
        # padding.
        for fdim, cell in ((1, g["base_cell_size"]), (4, g["base_cell_size"]),
                           (12, g["base_cell_size"]), (4, fine_cell)):
            grid, x, bound = _grid_case(g["bound"], cell, fdim, N_POINTS, 20 + fdim)
            level = "coarse" if cell == g["base_cell_size"] else "fine"
            padded = 10.0 * torch.randn((grid.shape[0] + 3, grid.shape[1] + 2,
                                         grid.shape[2] + 1, fdim), device=dev)
            padded[:grid.shape[0], :grid.shape[1], :grid.shape[2]] = grid
            size = torch.tensor(grid.shape[:3], dtype=torch.int32, device=dev)
            log(f"  interp {level} sized F={fdim}: storage {tuple(padded.shape)}, forward path "
                f"{_fwd_path(padded, N_POINTS)}")
            _check_values(f"interp_{level}_sized_F{fdim}_vs_unpadded",
                          grid_interpolate_cuda(padded, x, bound, size),
                          grid_interpolate_plain(grid, x, bound), errs)
            _check_values(f"interp_{level}_sized_F{fdim}",
                          grid_interpolate_cuda(padded, x, bound, size),
                          grid_interpolate_plain(padded, x, bound, size), errs)
            _interp_grad_check(f"{level}_sized_F{fdim}", padded, x, bound, size, errs,
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
        rec = {"grid": list(grid.shape), "points": n, "fwd_path": _fwd_path(grid, n),
               "copies": interp_grad_copies(grid.shape[:3], 4, n)}
        with torch.no_grad():
            rec["fwd"] = dict(ms=cuda_ms(lambda: grid_interpolate_cuda(grid, x, bound)),
                              device_ms=_kernel_device_ms(
                                  lambda: grid_interpolate_cuda(grid, x, bound)),
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
        log(f"  {name} {tuple(grid.shape)}, {n} points, forward path {rec['fwd_path']}, grad "
            f"on {rec['copies']} copies: " +
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
    t_tc, t_dot = _mlp_op_ms(params, n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    tc = (max(t_tc, t_dot), "operations") if max(t_tc, t_dot) >= t_bytes else (t_bytes, "bytes")
    simt = _bound(nbytes, 2.0 * sum(W.shape[0] * W.shape[1] for W, _ in params) * n)
    return tc, simt


def _mlp_op_ms(params, n):
    """Least ms of the MLP kernels' two units for n points: the hidden layers
    (every layer when the output is wider than 4) in 3xTF32 on the tensor
    cores, widths padded to 8; an output layer of at most 4 columns in FP32
    on the CUDA cores, k padded to 8."""
    fout = params[-1][0].shape[1]
    mma_layers = params[:-1] if fout <= 4 else params
    padded = sum(-(-W.shape[0] // 8) * 8 * -(-W.shape[1] // 8) * 8 for W, _ in mma_layers)
    dot = -(-params[-1][0].shape[0] // 8) * 8 * fout if fout <= 4 else 0
    return (3 * 2.0 * padded * n / PEAK_TF32_FLOPS * 1e3,
            2.0 * dot * n / PEAK_FP32_FLOPS * 1e3)


def _device_events(fn, calls=TIMED_CALLS):
    """(name, device microseconds) of every kernel and memset that ``calls``
    calls of fn ran under torch.profiler, after 3 calls of warm-up: the
    device's own time, without the host's launch cost in it.  The tracer can
    miss the first kernels of a window, so the window opens on 2 more calls,
    and the timed calls are the events between two spin kernels (markers)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, (_, name, _) in enumerate(events) if "spin_kernel" in name]
    if len(marks) != 2:
        return []
    return [(name, us) for _, name, us in events[marks[0] + 1:marks[1]]]


def _queued_ms(fn, calls=TIMED_CALLS, warmup=3):
    """Mean device milliseconds per call of fn, by CUDA events around calls
    queued behind a spin kernel, so that the device runs them back to back
    without waiting on the host.  It counts every kernel of fn and the gaps
    between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ~25 ms at 1.98 GHz: the host's head start
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _kernel_device_ms(fn, kernel_name=None, calls=TIMED_CALLS):
    """Mean device milliseconds per launch of the kernels whose name contains
    ``kernel_name`` (or per call, of every kernel and memset fn runs, when
    None), over ``calls`` calls of fn (:func:`_device_events`).  The profiler
    now and then returns windows short of events, several in a row: a short
    window is taken again, twice at most, and then the time is read by CUDA
    events instead (:func:`_queued_ms`)."""
    for _ in range(3):
        us = [t for name, t in _device_events(fn, calls)
              if kernel_name is None or kernel_name in name]
        if us and (len(us) == calls if kernel_name else len(us) % calls == 0):
            return sum(us) / calls / 1e3
    log(f"  profiler saw {len(us)} {kernel_name or 'kernel'} launches in {calls} calls, "
        f"three times: device time read by CUDA events around calls queued back to back")
    return _queued_ms(fn, calls)


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
    """Each kernel wrapper's launch counter (wrapper, attribute) that a path
    zeroes and reads: the interp backward counts its points-only mode apart."""
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda, mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_grad_cuda
    return {"interp": (grid_interpolate_cuda, "launches"),
            "interp_grad": (grid_interpolate_grad_cuda, "launches"),
            "interp_points_grad": (grid_interpolate_grad_cuda, "points_launches"),
            "decode": (mlp_decode_cuda, "launches"),
            "fused": (fused_interp_decode_cuda, "launches")}


def _zero_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    _GridInterp.recomputes = 0


def _read_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp
    out = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
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
                                {"interp": 2, "interp_grad": 2, "interp_points_grad": 0,
                                 "decode": 1, "fused": 0})
    log("  decoder.impl \"pallas\" (the fused kernel):")
    fused = run_mapping_steps(SCANNET_MODEL_FUSED, FUSED_TIMED_STEPS,
                              {"interp": 0, "interp_grad": 0, "interp_points_grad": 0,
                               "decode": 0, "fused": 1})
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
    differentiates.  Returns the errors and the interp forward's times on the
    lattice chunk, per level."""
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_grad_plain,
        grid_interpolate_plain)
    from miso_tpu_torch.utils.sdf import lattice_chunk_points
    errs, times = {}, {}
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
                    call = lambda: grid_interpolate_cuda(grid, x, bound)  # noqa: E731
                    t = dict(grid=list(grid.shape), points=x.shape[0],
                             path=_fwd_path(grid, x.shape[0]),
                             ms=cuda_ms(call), device_ms=_kernel_device_ms(call),
                             plain_ms=cuda_ms(lambda: grid_interpolate_plain(grid, x, bound)))
                    t["bound_ms"], t["bound_by"] = _interp_bounds(grid, x, False)
                    times[f"L{level}"] = t
                    log(f"  interp forward on the lattice chunk, level {level} "
                        f"{tuple(grid.shape)} on path {t['path']}, {x.shape[0]} points: call "
                        f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, plain "
                        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
                    continue
                cot = torch.randn(f.shape, generator=gen, device=dev)
                d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, cot)
                r_grid, r_x = grid_interpolate_grad_plain(grid, x, bound, cot)
                _check_grad(f"mesh_grad_{name}_L{level}_table", d_grid, r_grid, errs)
                _check_grad(f"mesh_grad_{name}_L{level}_points", d_x, r_x, errs)
            feats = torch.cat(feats, dim=-1)
            _check_values(f"mesh_decode_{name}", mlp_decode_cuda(decoder, feats),
                          mlp_decode_plain(decoder, feats), errs)
    return errs, times


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
    kernel_errs, lattice_interp = _mesh_kernel_checks(model, ds)
    return dict(
        epochs=epochs, train_s=train_s, epochs_per_s=epochs / train_s,
        step_ms_median=float(np.median(step_ms)),
        step_ms_p10=float(np.percentile(step_ms, 10)),
        loss_first=losses[0], loss_last=losses[-1], train_launches=train_counts,
        resolution=MESH_RESOLUTION, lattice_points=MESH_RESOLUTION ** 3,
        lattice_chunks=chunks, save_mesh_s=mesh_s, lattice_launches=lattice_counts,
        lattice_s=lattice_s, marching_cubes_s=mc_s, mesh_vertices=len(mesh.vertices),
        mesh_triangles=len(mesh.triangles), metrics=metrics,
        lattice_interp_fwd=lattice_interp), kernel_errs


# ---------------------------------------------------------------------------
# Phase 5: online SLAM of one submap (demo/full_slam_scannet.py --synthetic).
# ---------------------------------------------------------------------------

SLAM_FRAMES = 24
# demo/full_slam_scannet.py:83-91: the sequence's sensor and sampling.
SLAM_SEQ = dict(frame_samples=2 ** 13, frame_batchsize=4096, trunc_dist=0.3,
                near_surface_std=0.1, odom_std_rad=0.002, odom_std_meter=0.005)
# The submap frame is the first camera's: a cube that holds the room from
# there (demo/full_slam_scannet.py:92-98).
SLAM_BOUND = [[-6.5, 6.5], [-6.5, 6.5], [-6.5, 6.5]]
SLAM_PRETRAIN_EPOCHS = 200
MAX_ATE_M = 0.03
# The LM run, tests/test_slam.py:120-140: a grid trained on keyframes 0-7,
# keyframe 5 rotated by 0.03 rad about z and moved by (5, -4, 2) cm.
LM_TRAIN_KFS = 8
LM_TRAIN_EPOCHS = 120
LM_KF = 5
LM_ROT = [0.0, 0.0, 0.03]
LM_SHIFT = [0.05, -0.04, 0.02]
LM_MAX_ROT_DEG = float(np.degrees(0.03))


def slam_config():
    """configs/rgbd/scannet.yaml with demo/full_slam_scannet.py's synthetic
    overrides (:97-119), through the port's load_config."""
    from miso_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "rgbd", "scannet.yaml"))
    cfg["system"].update({"submap_size": 100, "submap_local_bound": SLAM_BOUND,
                          "profile": True})
    cfg["model"]["grid"].update({"base_cell_size": 0.5, "per_level_scale": 5.0,
                                 "bound": SLAM_BOUND})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None, "hidden_dim": 32})
    cfg["model"]["pose"]["num_poses"] = 100
    cfg["mapping"].update({"trunc_dist": 0.3, "finite_diff_eps": 0.05, "eik_trunc_dist": 0.3,
                           "weight_fs": 0.2, "learning_rate": 3e-3, "use_stability": True})
    cfg["tracking"].update({"solver": "adam", "loss_type": "L1", "learning_rate": 1e-3,
                            "trunc_dist": None, "verbose": False})
    return cfg


def slam_sequence(n_frames=SLAM_FRAMES, seq_kw=SLAM_SEQ):
    """room_scene(5.0, seed=0) and the demo's orbit, simulated on the host."""
    from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    mesh = TriangleMesh(*room_scene(5.0, seed=0))
    R, t = orbit_trajectory([0, 0, 0], 1.8, 1.4, n_frames, look_at=[0, 0, -0.5])
    return mesh, SdfSequence(mesh, R, t, **seq_kw)


def pretrain_decoder(mesh, cfg_model, device, epochs=SLAM_PRETRAIN_EPOCHS,
                     batch=2 ** 13, total=2 ** 16):
    """demo/full_slam_scannet.py::pretrain_decoder_synthetic: the decoder
    trained with a grid on the scene's SDF, then kept."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.train.trainer import GridTrainer
    ds = Sdf3D(mesh, batch_size=batch, total_samples=total, trunc_dist=0.3)
    cfg = copy.deepcopy(cfg_model)
    cfg["decoder"].update({"fix": False, "pretrained_model": None})
    cfg["pose"] = {"optimize": False, "num_poses": 1}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(7), device=device)
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=0.3)
    GridTrainer({"optimizer": "adam", "learning_rate": 5e-3, "epochs": epochs,
                 "max_epochs_in_level": epochs // 3,
                 "grid_training_mode": "coordinate+joint"}, model, loss_fn, ds).train()
    return tuple((W.detach(), b.detach()) for W, b in model.decoder_params)


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, np.reshape(t, 3)
    return T


def odometry_trajectory(ds):
    """(n, 4, 4): keyframe 0's pose composed with the odometry alone."""
    T = [_pose(*ds.noisy_kf_pose_in_world(0))]
    for k in range(ds.num_kfs - 1):
        T.append(T[-1] @ ds.get_odometry_at_pose(k))
    return np.stack(T)


def run_online(cfg, ds, device, counters):
    """SubmapSlam over the whole sequence; returns the report, the world
    trajectory (n, 4, 4) and the grid."""
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.slam.submap_slam import SubmapSlam
    grid = create_grid_net(cfg["model"], bound=cfg["system"]["submap_local_bound"],
                           num_poses=cfg["system"]["submap_size"],
                           generator=torch.Generator().manual_seed(0), device=device)
    R0, t0 = ds.noisy_kf_pose_in_world(0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    _zero_counts(counters)
    t_start = time.perf_counter()
    slam = SubmapSlam(grid, ds, ds, cfg, R0, t0)
    sync()
    init_s = time.perf_counter() - t_start
    slam.run()
    sync()
    run_s = time.perf_counter() - t_start
    counts = _read_counts(counters)
    Rw, tw = slam.kf_poses_in_world()
    T_est = np.stack([_pose(R, t) for R, t in zip(Rw, tw)])
    m = cfg["mapping"]
    map_steps = m.get("init_iterations", 50) + (ds.num_kfs - 1) * m.get("iters_per_frame", 15)
    track_steps = (ds.num_kfs - 1) * 15
    report = dict(frames=slam.num_keyframes, init_s=init_s, run_s=run_s, launches=counts,
                  map_steps=map_steps, track_steps=track_steps,
                  stage_ms={k: [float(v) for v in vs] for k, vs in slam.stage_ms.items()})
    return report, T_est, slam.grid


def run_lm_recovery(cfg, lidar_tracking, ds, device, counters, train_epochs=LM_TRAIN_EPOCHS):
    """The LM run: a grid in world coordinates trained on keyframes 0-7 at
    their true poses (features and stability, poses locked), keyframe 5
    perturbed, then Tracker.track_lm with the LiDAR profile's settings.
    Returns the report, the tracker and a batch of its last solve."""
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.slam.tracker import Tracker
    from miso_tpu_torch.train.trainer import GridTrainer
    model = create_grid_net(cfg["model"], num_poses=ds.num_kfs,
                            generator=torch.Generator().manual_seed(0), device=device)
    kfs = list(range(LM_TRAIN_KFS))
    for kf in kfs:
        model.set_initial_kf_pose(kf, *ds.true_kf_pose_in_world(kf))
    ds.select_keyframes(kfs)
    loss_fn = make_loss(mapping_loss, loss_type="L1", weight_sdf=1.0, weight_eik=0.0,
                        weight_fs=0.2, trunc_dist=0.3)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    GridTrainer({"optimizer": "adam", "learning_rate": 5e-3, "epochs": train_epochs,
                 "max_epochs_in_level": 40, "grid_training_mode": "coordinate+joint"},
                model, loss_fn, ds,
                mask_for_level=lambda m, level: grid_net_mask(m, level=level,
                                                              pose=False)).train()
    sync()
    train_s = time.perf_counter() - t0
    R_np, t_np = ds.true_kf_pose_in_world(LM_KF)
    dR = se3.so3_exp(torch.tensor(LM_ROT)).numpy()
    model.set_initial_kf_pose(LM_KF, R_np @ dR, t_np + np.asarray(LM_SHIFT, np.float32))
    R_gt, t_gt = (torch.as_tensor(a, device=device) for a in (R_np, t_np))
    tracker = Tracker(model, ds, {"tracking": lidar_tracking})
    R0, t0_ = tracker.grid.updated_kf_pose(LM_KF)
    err_t0 = float(torch.linalg.vector_norm(t0_ - t_gt))
    err_r0 = float(se3.rotation_rmse_deg(R0[None], R_gt[None]))
    sync()
    _zero_counts(counters)
    t0 = time.perf_counter()
    tracker.track_lm(LM_KF)
    sync()
    track_ms = 1e3 * (time.perf_counter() - t0)
    counts = _read_counts(counters)
    R1, t1 = tracker.grid.updated_kf_pose(LM_KF)
    report = dict(train_s=train_s, train_epochs=train_epochs, err_t0_m=err_t0,
                  err_r0_deg=err_r0, err_t1_m=float(torch.linalg.vector_norm(t1 - t_gt)),
                  err_r1_deg=float(se3.rotation_rmse_deg(R1[None], R_gt[None])),
                  iterations=int(lidar_tracking["lm_max_iter"]), track_lm_ms=track_ms,
                  sample_ms=1e3 * tracker.last_sample_time,
                  fov_overlap=tracker.latest_fov_overlap, launches=counts)
    return report, tracker


def _points_bounds(grid, x, bound):
    """(ms, what bounds it) of one points-only backward: x and the cotangent
    read once, the table's rows that these points' valid corners touch read
    once (a gather needs no more of the table), d_x written; 2 FMA a corner
    and feature for the dots and 2 a corner and axis for the weights'
    derivatives."""
    from miso_tpu_torch.ops.interp import corner_indices_and_weights
    n, fdim = x.shape[0], grid.shape[-1]
    lin, w = corner_indices_and_weights(x, bound, tuple(grid.shape[:3]))
    rows = int(torch.unique(lin[w != 0]).numel())
    nbytes = (x.numel() + n * fdim + rows * fdim + 3 * n + 6) * 4
    return _bound(nbytes, 2.0 * 8 * (fdim + 3) * n)


def _points_only_case(name, grid, x, bound, errs, seed):
    """The points-only mode against its plain version, and its times beside
    the table-and-points call, the plain version and grid_sample's backward
    with only the input's gradient asked for."""
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain)
    dev = x.device
    cot = torch.randn((x.shape[0], grid.shape[-1]),
                      generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    got = grid_interpolate_grad_cuda(grid, x, bound, cot, need_grid=False)
    ref = grid_interpolate_grad_plain(grid, x, bound, cot, need_grid=False)
    check(got[0] is None and ref[0] is None, f"{name}: a table gradient in the points-only mode")
    _check_values(f"points_only_{name}", got[1], ref[1], errs)
    call = lambda: grid_interpolate_grad_cuda(grid, x, bound, cot, need_grid=False)  # noqa: E731
    vol, coords = _grid_sample_inputs(grid, x, bound)
    coords_r = coords.clone().requires_grad_()
    out = _grid_sample(vol, coords_r)
    gout = cot.T.reshape(out.shape).contiguous()
    both = lambda: grid_interpolate_grad_cuda(grid, x, bound, cot)  # noqa: E731
    t = dict(grid=list(grid.shape), points=x.shape[0], ms=cuda_ms(call),
             device_ms=_kernel_device_ms(call), table_and_points_ms=cuda_ms(both),
             table_and_points_device_ms=_kernel_device_ms(both),
             plain_ms=cuda_ms(lambda: grid_interpolate_grad_plain(grid, x, bound, cot,
                                                                  need_grid=False)),
             library_ms=cuda_ms(lambda: torch.autograd.grad(out, coords_r, gout,
                                                            retain_graph=True)))
    t["bound_ms"], t["bound_by"] = _points_bounds(grid, x, bound)
    log(f"  points-only backward {name} {tuple(grid.shape)}, {x.shape[0]} points: call "
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), table and points "
        f"{t['table_and_points_ms']:.4f} (device {t['table_and_points_device_ms']:.4f}), "
        f"plain {t['plain_ms']:.4f}, grid_sample input-only "
        f"backward {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return t


def _slam_kernel_checks(grid, ds, lm_grid, lm_batch):
    """The slam path's kernels against their plain versions at its shapes: a
    mapping batch of 11 x 4096 points and a tracking batch of 4096 on the
    online run's grid (interp forward, table-and-points backward, decode);
    the points-only backward on the LM run's grid at the tracker's 4096
    points and on the ScanNet levels at 1e6 points."""
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_grad_plain,
        grid_interpolate_plain)
    errs, times = {}, {}
    dev = grid.bound.device
    gen = torch.Generator(device=dev).manual_seed(70)
    ds.select_keyframes(list(range(11)))
    b = ds.sample(np.random.default_rng(70))
    R, t = grid.updated_kf_poses()
    ids = torch.as_tensor(b["sample_frame_ids"], device=dev).long()
    mapping = se3.transform_points_by_id(torch.as_tensor(b["coords_frame"], device=dev),
                                         ids, R.detach(), t.detach()).contiguous()
    decoder = tuple((W.detach(), bb.detach()) for W, bb in grid.decoder_params)
    with torch.no_grad():
        for name, x in (("mapping", mapping), ("tracking", mapping[:4096].contiguous())):
            feats = []
            for level, param in enumerate(grid.features):
                table = param.detach()
                f = grid_interpolate_cuda(table, x, grid.bound)
                _check_values(f"slam_interp_{name}_L{level}", f,
                              grid_interpolate_plain(table, x, grid.bound), errs)
                feats.append(f)
                cot = torch.randn(f.shape, generator=gen, device=dev)
                d_grid, d_x = grid_interpolate_grad_cuda(table, x, grid.bound, cot)
                r_grid, r_x = grid_interpolate_grad_plain(table, x, grid.bound, cot)
                _check_grad(f"slam_grad_{name}_L{level}_table", d_grid, r_grid, errs)
                _check_grad(f"slam_grad_{name}_L{level}_points", d_x, r_x, errs)
            feats = torch.cat(feats, dim=-1)
            _check_values(f"slam_decode_{name}", mlp_decode_cuda(decoder, feats),
                          mlp_decode_plain(decoder, feats), errs)
    for level, param in enumerate(lm_grid.features):
        times[f"lm_L{level}"] = _points_only_case(f"lm_L{level}", param.detach(), lm_batch,
                                                  lm_grid.bound, errs, 71 + level)
    for seed, (name, bl, cell, n) in enumerate(INTERP_SHAPES[:2], start=73):
        g_, x_, b_ = _grid_case(bl, cell, 4, n, seed)
        times[name] = _points_only_case(name, g_, x_, b_, errs, seed)
    return errs, times


def _percentiles(ms):
    ms = np.asarray(ms)
    return dict(median=float(np.median(ms)), p90=float(np.percentile(ms, 90)))


def phase_slam():
    """demo/full_slam_scannet.py --synthetic through the port: the decoder
    pretrained and fixed, the init burst, then per frame odometry,
    Tracker.track (Adam) and a mapping burst; ATE against the ground truth
    and against the odometry alone.  Then the LM run on the same sequence and
    model.  Launch counts exact for both; the kernels held to their plain
    versions at the path's shapes."""
    import tempfile

    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.train.checkpoint import save_pytree
    from miso_tpu_torch.utils.eval import trajectory_error

    dev = torch.device("cuda")
    counters = kernel_counters()
    t0 = time.perf_counter()
    mesh, ds = slam_sequence()
    seq_s = time.perf_counter() - t0
    cfg = slam_config()
    t0 = time.perf_counter()
    decoder = pretrain_decoder(mesh, cfg["model"], dev)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    log(f"  sequence: {ds.num_kfs} frames simulated in {seq_s:.2f} s; decoder pretrained "
        f"({SLAM_PRETRAIN_EPOCHS} epochs) in {pretrain_s:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decoder.npz")
        save_pytree(path, decoder)
        cfg["model"]["decoder"].update({"fix": True, "pretrained_model": path})
        online, T_est, grid = run_online(cfg, ds, dev, counters)
        lidar = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
        lm, tracker = run_lm_recovery(cfg, dict(lidar["tracking"]), ds, dev, counters)

    T_gt = np.stack([_pose(*ds.true_kf_pose_in_world(k)) for k in range(ds.num_kfs)])
    ate = trajectory_error(T_est, T_gt, align=True)
    ate_odom = trajectory_error(odometry_trajectory(ds), T_gt, align=True)
    online.update(ate=ate, ate_odometry_only=ate_odom,
                  track_ms=_percentiles(online["stage_ms"]["track"]),
                  map_ms=_percentiles(online["stage_ms"]["map"]))
    c = online["launches"]
    log(f"  online: {online['frames']} frames, init burst {online['init_s']:.2f} s, run "
        f"{online['run_s']:.2f} s; track {online['track_ms']['median']:.2f} ms median, "
        f"{online['track_ms']['p90']:.2f} ms p90; map {online['map_ms']['median']:.2f} ms "
        f"median, {online['map_ms']['p90']:.2f} ms p90 (CUDA-synchronized); launches {c}")
    log(f"  ATE RMSE {100 * ate['ate_rmse']:.3f} cm, rotation RMSE "
        f"{ate['rot_rmse_deg']:.4f} deg; odometry alone: ATE RMSE "
        f"{100 * ate_odom['ate_rmse']:.3f} cm, rotation RMSE {ate_odom['rot_rmse_deg']:.4f} deg")
    check(ate["ate_rmse"] < ate_odom["ate_rmse"],
          f"ATE {ate['ate_rmse']:.4f} m not below the odometry's {ate_odom['ate_rmse']:.4f} m")
    check(ate["ate_rmse"] < MAX_ATE_M, f"ATE {ate['ate_rmse']:.4f} m not below {MAX_ATE_M} m")
    # Mapping (features and stability queried: 4 interp and 4 interp grad a
    # step) and Adam tracking (2 and 2) take the table-gradient backward.
    ms, ts = online["map_steps"], online["track_steps"]
    want = {"interp": 4 * ms + 2 * ts, "interp_grad": 4 * ms + 2 * ts,
            "decode": ms + ts, "interp_points_grad": 0, "fused": 0,
            "interp_recompute_backward": 0}
    for name, n in want.items():
        check(c[name] == n, f"online run: {name} launched {c[name]} times, expected {n} "
              f"({ms} mapping and {ts} tracking steps)")

    c = lm["launches"]
    log(f"  LM run: grid trained on keyframes 0-{LM_TRAIN_KFS - 1} ({lm['train_epochs']} "
        f"epochs) in {lm['train_s']:.2f} s; keyframe {LM_KF} from {100 * lm['err_t0_m']:.2f} "
        f"cm, {lm['err_r0_deg']:.3f} deg to {100 * lm['err_t1_m']:.3f} cm, "
        f"{lm['err_r1_deg']:.4f} deg in {lm['iterations']} iterations, "
        f"{lm['track_lm_ms']:.2f} ms (host sampling {lm['sample_ms']:.2f} ms); "
        f"fov overlap {lm['fov_overlap']:.3f}; launches {c}")
    check(lm["err_t1_m"] <= 0.5 * lm["err_t0_m"],
          f"LM: translation error {lm['err_t1_m']:.4f} m, more than half of "
          f"{lm['err_t0_m']:.4f} m")
    check(lm["err_r1_deg"] < LM_MAX_ROT_DEG,
          f"LM: rotation error {lm['err_r1_deg']:.4f} deg not under {LM_MAX_ROT_DEG:.2f}")
    k = lm["iterations"]
    want = {"interp": 2 * k, "interp_points_grad": 2 * k, "decode": k, "interp_grad": 0,
            "fused": 0, "interp_recompute_backward": 0}
    for name, n in want.items():
        check(c[name] == n, f"LM run: {name} launched {c[name]} times in {k} iterations, "
              f"expected {n}")

    log("  the slam path's kernels against their plain versions:")
    ds.select_keyframes([LM_KF])
    b = ds.sample(np.random.default_rng(72))
    R, t = tracker.grid.updated_kf_pose(LM_KF)
    lm_batch = se3.transform_points_to(torch.as_tensor(b["coords_frame"], device=dev),
                                       R, t).contiguous()
    errs, times = _slam_kernel_checks(grid, ds, tracker.grid, lm_batch)
    return dict(online=online, lm=lm, points_only=times), errs


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

    log("phase 5: online SLAM of one submap (demo/full_slam_scannet.py --synthetic)")
    slam_report, slam_errs = phase_slam()
    errs.update(slam_errs)

    log("phase 6: report")
    print(json.dumps({"card": card, "build_s": build_s, "max_abs_err": errs,
                      "fused_kernel": times, "interp_kernels": interp_times,
                      "decode_kernel": decode_t,
                      "main_path": main_report, "main_path_fused": fused_report,
                      "mesh_path": mesh_report, "slam_path": slam_report}), flush=True)

    def launches(name):
        """The launches on the paths that run the kernel: phase 3's
        default-decode run, phase 4's training and lattice, and phase 5's
        online run and LM run."""
        return (main_report["launches"][name] + mesh_report["train_launches"][name]
                + mesh_report["lattice_launches"][name]
                + slam_report["online"]["launches"][name] + slam_report["lm"]["launches"][name])

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
                     worst("interp_grad_fine_F4", "interp_grad_coarse_F4", "mesh_grad_",
                           "slam_grad_"),
                     fine["grad"])
    backward.update(points_grad_ms=fine["grad_x"]["ms"],
                    points_grad_bound_ms=fine["grad_x"]["bound_ms"],
                    coarse_ms=coarse["grad"]["ms"], coarse_bound_ms=coarse["grad"]["bound_ms"],
                    coarse_copies=coarse["copies"])
    # The fused kernel's entry: its call at the ScanNet widths, bound by its
    # 3xTF32 operations; beside it the FP32 bound, the kernel's device time,
    # the sum of the parts it fuses in the same call and which levels it
    # staged.  The interp forward's: the fine level's call, and beside it the
    # coarse level's, the path each took and the lattice chunk's calls.
    fused = entry("fused_interp_decode", "miso_tpu_torch/csrc/fused_interp_decode.cu",
                  "miso_tpu/ops/pallas_decode.py:186", fused_report["launches"]["fused"],
                  worst("fused_"), times)
    fused.update(bound_note="3xTF32 tensor-core operations", fp32_bound_ms=times["fp32_bound_ms"],
                 device_ms=times["device_ms"], parts_sum_ms=times["parts_sum_ms"],
                 levels_staged=times["levels_staged"])
    forward = entry("grid_interp_forward", "miso_tpu_torch/csrc/grid_interp.cu",
                    "miso_tpu/ops/pallas_interp.py:196", launches("interp"),
                    worst("interp_fine_F4", "interp_coarse_F4", "mesh_interp_", "slam_interp_"),
                    fine["fwd"])
    lattice = mesh_report["lattice_interp_fwd"]
    forward.update(path=fine["fwd_path"], device_ms=fine["fwd"]["device_ms"],
                   coarse_path=coarse["fwd_path"], coarse_ms=coarse["fwd"]["ms"],
                   coarse_device_ms=coarse["fwd"]["device_ms"],
                   coarse_bound_ms=coarse["fwd"]["bound_ms"],
                   lattice_device_ms={k: v["device_ms"] for k, v in lattice.items()},
                   lattice_paths={k: v["path"] for k, v in lattice.items()})
    # The points-only mode's entry: its call at the LM run's 4096 points on
    # the fine level of the tracker's grid; beside it the coarse level's and
    # the ScanNet levels' at 1e6 points.
    po = slam_report["points_only"]
    points_only = entry("grid_interp_points_backward", "miso_tpu_torch/csrc/grid_interp.cu",
                        "miso_tpu/ops/pallas_interp.py:268", launches("interp_points_grad"),
                        worst("points_only_"), po["lm_L1"])
    points_only.update(mode="need_grid=False of grid_interpolate_grad_cuda",
                       device_ms=po["lm_L1"]["device_ms"],
                       table_and_points_ms=po["lm_L1"]["table_and_points_ms"],
                       table_and_points_device_ms=po["lm_L1"]["table_and_points_device_ms"],
                       coarse_ms=po["lm_L0"]["ms"], coarse_bound_ms=po["lm_L0"]["bound_ms"],
                       scannet_1e6={k: {f: po[k][f] for f in (
                           "ms", "device_ms", "table_and_points_ms",
                           "table_and_points_device_ms", "plain_ms", "library_ms", "bound_ms")}
                                    for k in ("scannet_fine", "scannet_coarse")})
    kernels = [fused, forward, backward, points_only,
               entry("mlp_decode", "miso_tpu_torch/csrc/mlp_decode.cu",
                     "miso_tpu/ops/pallas_decode.py:107", launches("decode"),
                     worst("decode_scannet", "mesh_decode_", "slam_decode_"), decode_t)]
    tpu_kernels = [
        {"replaces": "miso_tpu/ops/pallas_decode.py:186", "name": "_fused_kernel",
         "status": "ported and checked", "port": "fused_interp_decode"},
        {"replaces": "miso_tpu/ops/pallas_decode.py:107", "name": "_decode_kernel",
         "status": "ported and checked", "port": "mlp_decode"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:196", "name": "_interp_kernel",
         "status": "ported and checked", "port": "grid_interp_forward"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:268", "name": "_interp_grad_kernel",
         "status": "ported and checked",
         "port": "grid_interp_backward, grid_interp_points_backward"},
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
