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
                 gradients) at the ScanNet fine and coarse levels, F=1 and
                 F=12, 1e6 points, and with padded storage;
               * the decode kernel at 8->64->64->1, 8->64x3->3 and 1->4->1
                 with 1e6 points, and without biases;
               * first- and second-order gradients through the interp and
                 decode autograd.Functions against the plain versions';
               * kernel, plain and library (grid_sample) times against the
                 bound of each at the ScanNet sizes;
  3. main    - the mapping train step that bench.py drives, at full ScanNet
               width: GridNet (2 levels, F=4, 0.5 m / 0.1 m cells, 64x1
               decoder, 372 poses, decoder.impl "pallas"), mapping_loss with
               L1 SDF + free space, masked Adam, 4 rotating 1e6-point batches,
               3 warm-up and 20 timed steps; the first loss against a plain
               CPU copy of the model;
  4. mesh    - the synthetic mesh path at the ScanNet widths with the default
               decode: room_scene(4.0) -> Sdf3D -> GridTrainer (tsdf_loss_3d,
               autograd eikonal, 300 epochs) -> save_mesh (192^3 lattice,
               marching cubes) -> Chamfer / F-score, with every training step
               and lattice chunk launching the interp, interp grad and decode
               kernels; then those kernels held to their plain versions on
               the trained model at the path's shapes (a 2^15-point batch,
               2^15 eikonal points, a 2^18-point lattice chunk);
  5. report  - the card, step times, kernel times against the bound, and the
               kernels line; the last line is {"ok": true, "device": ...}.

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
# cores, and HBM3 bandwidth.  The bound of a call is the larger of its FP32
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Values: float32 sums taken in another order than the plain version's
# (per-corner FMAs, MLP rows accumulated in registers) differ by a few ulp of
# the largest partial sum; 1e-4 absolute and relative leaves a wide margin.
VALUE_ATOL = 1e-4
VALUE_RTOL = 1e-4
# Gradients: both sides run the same torch-op recompute, but the scatter-add
# into the grids accumulates with atomics in a run-dependent order.
GRAD_RTOL_OF_MAX = 1e-4

# configs/rgbd/scannet.yaml's model, as bench.py trains it: a free decoder
# (fix: false, no pretrained weights) on features drawn with init_stddev 1e-4,
# and decoder.impl "pallas" for the fused kernel.
SCANNET_MODEL = {
    "spatial_dim": 3,
    "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
             "bound": [[-0.02, 10.38], [-0.01, 8.74], [-0.01, 3.03]],
             "base_cell_size": 0.5, "per_level_scale": 5.0, "n_levels": 2},
    "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1,
                "out_dim": 1, "pos_invariant": True, "fix": False,
                "pretrained_model": None, "impl": "pallas"},
    "pose": {"optimize": False, "num_poses": 372},
}
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


def phase_interp_kernels():
    """The interp forward and grad kernels against their plain versions, and
    their times at the ScanNet fine level beside grid_sample's."""
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_grad_plain,
        grid_interpolate_plain)
    errs = {}
    g = SCANNET_MODEL["grid"]
    fine_cell = g["base_cell_size"] / g["per_level_scale"]
    cases = [("fine_F4", g["bound"], fine_cell, 4),
             ("coarse_F4", g["bound"], g["base_cell_size"], 4),
             ("base_F1", [[-1.0, 1.0]] * 3, 1.0, 1),
             ("coarse_F12", g["bound"], g["base_cell_size"], 12)]
    dev = torch.device("cuda")
    with torch.no_grad():
        for seed, (name, bl, cell, fdim) in enumerate(cases, start=10):
            grid, x, bound = _grid_case(bl, cell, fdim, N_POINTS, seed)
            log(f"  interp {name}: grid {tuple(grid.shape)}, {N_POINTS} points")
            _check_values(f"interp_{name}", grid_interpolate_cuda(grid, x, bound),
                          grid_interpolate_plain(grid, x, bound), errs)
            gen = torch.Generator(device=dev).manual_seed(seed + 100)
            cot = torch.randn((N_POINTS, fdim), generator=gen, device=dev)
            d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, cot)
            r_grid, r_x = grid_interpolate_grad_plain(grid, x, bound, cot)
            _check_grad(f"interp_grad_{name}_table", d_grid, r_grid, errs)
            _check_grad(f"interp_grad_{name}_points", d_x, r_x, errs)
            d_grid_only, none = grid_interpolate_grad_cuda(grid, x, bound, cot,
                                                           need_x=False)
            check(none is None, "need_x=False returned a points' gradient")
            _check_grad(f"interp_grad_{name}_table_only", d_grid_only, r_grid, errs)
        # Padded storage with a logical size, as the fused kernel takes it.
        grid, x, bound = _grid_case(g["bound"], g["base_cell_size"], 4, N_POINTS, 20)
        padded = 10.0 * torch.randn((grid.shape[0] + 3, grid.shape[1] + 2,
                                     grid.shape[2] + 1, 4), device=dev)
        padded[:grid.shape[0], :grid.shape[1], :grid.shape[2]] = grid
        size = torch.tensor(grid.shape[:3], dtype=torch.int32, device=dev)
        _check_values("interp_sized_vs_unpadded",
                      grid_interpolate_cuda(padded, x, bound, size),
                      grid_interpolate_plain(grid, x, bound), errs)

        # Times at the ScanNet fine level (the larger of the two per-level calls).
        grid, x, bound = _grid_case(g["bound"], fine_cell, 4, N_POINTS, 10)
        cot = torch.randn((N_POINTS, 4), generator=torch.Generator(device=dev)
                          .manual_seed(110), device=dev)
        vol, coords = _grid_sample_inputs(grid, x, bound)
        lib_out = _grid_sample(vol, coords).reshape(4, -1).T
        lib_err = _max_err(lib_out, grid_interpolate_plain(grid, x, bound))
        log(f"  grid_sample (yardstick only): max |grid_sample - plain| = {lib_err:.3e}")
        fwd = dict(ms=cuda_ms(lambda: grid_interpolate_cuda(grid, x, bound)),
                   plain_ms=cuda_ms(lambda: grid_interpolate_plain(grid, x, bound)),
                   library_ms=cuda_ms(lambda: _grid_sample(vol, coords)))
        fwd["bound_ms"], fwd["bound_by"] = _bound(
            (x.numel() + cot.numel() + grid.numel() + bound.numel()) * 4,
            2.0 * 8 * 4 * N_POINTS)
        bwd = dict(
            ms=cuda_ms(lambda: grid_interpolate_grad_cuda(grid, x, bound, cot,
                                                          need_x=False)),
            plain_ms=cuda_ms(lambda: grid_interpolate_grad_plain(grid, x, bound, cot,
                                                                 need_x=False)),
            points_ms=cuda_ms(lambda: grid_interpolate_grad_cuda(grid, x, bound, cot)))
    vol_r = vol.clone().requires_grad_()
    out = _grid_sample(vol_r, coords)
    gout = cot.T.reshape(out.shape).contiguous()
    bwd["library_ms"] = cuda_ms(lambda: torch.autograd.grad(out, vol_r, gout,
                                                            retain_graph=True))
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        (x.numel() + cot.numel() + grid.numel() + bound.numel()) * 4,
        2.0 * 8 * 4 * N_POINTS)
    for name, t in (("interp forward", fwd), ("interp grad (table only)", bwd)):
        log(f"  {name} at the fine level {tuple(grid.shape)}, {N_POINTS} points: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, grid_sample "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    log(f"  interp grad with the points' gradient: kernel {bwd['points_ms']:.4f} ms")
    return errs, fwd, bwd


def phase_decode_kernel():
    """The decode kernel against its plain version, and its time at the
    ScanNet decoder widths."""
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.mlp import mlp_init
    errs = {}
    dev = torch.device("cuda")
    cases = [("scannet_8_64_64_1", 8, 1, 64, 1), ("8_64x3_3", 8, 3, 64, 2),
             ("base_1_4_1", 1, 1, 4, 0)]
    with torch.no_grad():
        for seed, (name, fin, fout, hidden, layers) in enumerate(cases, start=30):
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((N_POINTS, fin), generator=gen, device=dev)
            params = mlp_init(fin, fout, hidden, layers,
                              generator=torch.Generator().manual_seed(seed), device=dev)
            _check_values(f"decode_{name}", mlp_decode_cuda(params, x),
                          mlp_decode_plain(params, x), errs)
        nobias = tuple((W, None) for W, _ in params)
        _check_values("decode_base_no_bias", mlp_decode_cuda(nobias, x),
                      mlp_decode_plain(nobias, x), errs)
        x = torch.randn((N_POINTS, 8), generator=torch.Generator(device=dev)
                        .manual_seed(30), device=dev)
        params = mlp_init(8, 1, 64, 1, generator=torch.Generator().manual_seed(30),
                          device=dev)
        t = dict(ms=cuda_ms(lambda: mlp_decode_cuda(params, x)),
                 plain_ms=cuda_ms(lambda: mlp_decode_plain(params, x)),
                 library_ms=None)
    t["bound_ms"], t["bound_by"] = _bound(
        (x.numel() + N_POINTS + sum(W.numel() + b.numel() for W, b in params)) * 4,
        2.0 * sum(W.shape[0] * W.shape[1] for W, _ in params) * N_POINTS)
    log(f"  decode 8->64->64->1, {N_POINTS} points: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
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
# Phase 3: the main path (fused kernel).
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


def phase_main_path(counter):
    """Returns the step report; ``counter`` is the kernel wrapper whose
    ``launches`` this phase zeroes and reads."""
    from miso_tpu_torch.losses.common import total_loss
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    model = create_grid_net(SCANNET_MODEL, generator=torch.Generator().manual_seed(0),
                            device=dev)
    check(model.decode_impl == "pallas", "main path must run the fused kernel")
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

    n_steps = WARMUP_STEPS + TIMED_STEPS
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_steps)]
    losses = []
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0
    t0 = time.perf_counter()
    for i in range(n_steps):
        events[i][0].record()
        model, opt_state, tl, _ = step(model, opt_state, batches[i % len(batches)],
                                       None, mask, lr)
        events[i][1].record()
        losses.append(tl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    losses = [float(v) for v in losses]
    step_ms = np.array([s.elapsed_time(e) for s, e in events[WARMUP_STEPS:]])

    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: first {losses[0]}, last {losses[-1]}")
    check(launches == n_steps,
          f"kernel launched {launches} times in {n_steps} steps; expected one per step")
    rel = abs(losses[0] - plain_first) / abs(plain_first)
    check(rel <= 1e-5, f"first step loss {losses[0]!r} vs the plain CPU model's "
          f"{plain_first!r}: relative difference {rel:.3e} > 1e-5")
    median = float(np.median(step_ms))
    report = dict(
        launches=launches, steps=n_steps, loss_first=losses[0], loss_last=losses[-1],
        loss_first_plain_cpu=plain_first, loss_first_rel_diff=rel,
        step_ms_median=median, step_ms_p10=float(np.percentile(step_ms, 10)),
        points_per_s=N_POINTS / (median * 1e-3), wall_s_all_steps=wall,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"  losses: first {losses[0]:.6f} (plain CPU model {plain_first:.6f}, rel diff "
        f"{rel:.2e}), last {losses[-1]:.6f}; kernel launches {launches} in "
        f"{n_steps} steps")
    return report


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
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda, mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (
        _GridInterp, grid_interpolate_cuda, grid_interpolate_grad_cuda)
    from miso_tpu_torch.train.trainer import GridTrainer
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import extract_fields, save_mesh

    counters = {"interp": grid_interpolate_cuda, "interp_grad": grid_interpolate_grad_cuda,
                "decode": mlp_decode_cuda, "fused": fused_interp_decode_cuda}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        _GridInterp.recomputes = 0

    def read_counts():
        out = {k: fn.launches for k, fn in counters.items()}
        out["interp_recompute_backward"] = _GridInterp.recomputes
        return out

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
    zero_counts()
    t0 = time.perf_counter()
    model = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
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
    zero_counts()
    t0 = time.perf_counter()
    mesh = save_mesh(model, model.bound, None, resolution=MESH_RESOLUTION)
    mesh_s = time.perf_counter() - t0
    lattice_counts = read_counts()
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
    from miso_tpu_torch.ops.fused_decode import (_library, fused_interp_decode_cuda,
                                                 mlp_decode_cuda)
    from miso_tpu_torch.ops.tiled_interp import (
        _library as _interp_library, grid_interpolate_cuda, grid_interpolate_grad_cuda)

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
                if "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
    log(f"  native runtime (g++): {native_s:.1f} s; build and load: {build_s:.1f} s")

    log("phase 2: kernels against their plain versions")
    errs, times = phase_kernels()
    interp_errs, interp_t, grad_t = phase_interp_kernels()
    decode_errs, decode_t = phase_decode_kernel()
    grad2_errs = phase_function_grads()
    errs.update(interp_errs)
    errs.update(decode_errs)
    errs.update(grad2_errs)

    log("phase 3: main path (mapping train step, fused kernel)")
    main_report = phase_main_path(fused_interp_decode_cuda)

    log("phase 4: synthetic mesh path (default decode)")
    mesh_report, mesh_errs = phase_mesh()
    errs.update(mesh_errs)

    log("phase 5: report")
    print(json.dumps({"card": card, "build_s": build_s, "max_abs_err": errs,
                      "main_path": main_report, "mesh_path": mesh_report}), flush=True)

    def mesh_launches(name):
        return (mesh_report["train_launches"][name]
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

    kernels = [
        entry("fused_interp_decode", "miso_tpu_torch/csrc/fused_interp_decode.cu",
              "miso_tpu/ops/pallas_decode.py:186", main_report["launches"],
              errs["scannet"], times),
        entry("grid_interp_forward", "miso_tpu_torch/csrc/grid_interp.cu",
              "miso_tpu/ops/pallas_interp.py:196", mesh_launches("interp"),
              worst("interp_fine_F4", "interp_coarse_F4", "mesh_interp_"), interp_t),
        entry("grid_interp_backward", "miso_tpu_torch/csrc/grid_interp.cu",
              "miso_tpu/ops/pallas_interp.py:268", mesh_launches("interp_grad"),
              worst("interp_grad_fine_F4", "interp_grad_coarse_F4", "mesh_grad_"),
              grad_t),
        entry("mlp_decode", "miso_tpu_torch/csrc/mlp_decode.cu",
              "miso_tpu/ops/pallas_decode.py:107", mesh_launches("decode"),
              worst("decode_scannet_8_64_64_1", "mesh_decode_"), decode_t),
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
