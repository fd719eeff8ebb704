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
               pretrained_model and fixed), then System on a GridAtlas of the
               config's capacity (8): the 50-iteration init burst, and per
               frame odometry, Adam tracking (15 iterations), a 15-iteration
               mapping burst drawn on the card from the resident pool and the
               pose-row sync; ATE and rotation RMSE after Umeyama alignment,
               beside the odometry-only trajectory's, which it must beat, and
               under 3 cm; the demo's 200-iteration refinement over every
               keyframe; observed_sdf_query(atlas.params, 0.2) meshed at 256^3
               over the atlas's global bound, whose F-score at 5 cm must come
               within 5 points of the JAX package's CPU run of the same demo;
               track, map and spawn ms per frame (StageProfiler) and one
               frame's idle share (miso_tpu_torch/utils/profiling.py's
               breakdown).  Then the LM run (tests/test_slam.py's recipe): a
               grid trained on keyframes 0-7, keyframe 5 perturbed,
               Tracker.track_lm with configs/lidar/ncd_quad.yaml's tracking
               settings, which must halve the translation error and end under
               1.72 degrees.  Launches exact in every run (per LM iteration 2
               interp forwards, 2 points-only interp backwards, 1 decode; per
               lattice chunk one interp forward per live slot and level for
               the features, as many for the stability, 1 decode); the
               kernels against their plain versions at the path's shapes, and
               the points-only backward at 4096 points and at 1e6 points on
               the ScanNet levels, timed beside the table-and-points call;
  6. quad    - demo/full_slam_newer_college.py --synthetic --scene quad
               --num_frames 60 --submap_size 30, through the Fuser: the 40 m
               courtyard, a LiDAR scan pattern (192 x 64), separate tracking
               (surface only, 0.6 m voxels) and mapping (0.1 m voxels)
               sequences, configs/lidar/ncd_quad.yaml with the demo's
               overrides: LM/GM tracking of 16 iterations, axis-aligned
               submaps that each cover the site's world box, capacity 8;
               exactly 2 submaps and 60 keyframes; the ATE within the
               submaps (each aligned on its own) under the odometry-only
               trajectory's, and the pre-fusion ATE beside the odometry's and
               within 5 cm of the JAX package's CPU run of the same
               configuration (scripts/jax_quad_prefusion.py --fuse: 29.05 cm
               against the odometry's 14.21 cm; across the submaps the
               trajectory carries the second anchor's drift until the Fuser
               aligns them); then the demo's Fuser stage (fuse_quad):
               Fuser.align with the demo's overrides of the config's align:
               section (latent level 1, then the SDF finetune, 50 iterations
               each, lr 2e-3, L2, 32768 capped alignment points a submap and
               level, 8192 a pair an iteration, each point of the pair batch
               queried in its own submap by the slot-id interp kernels), the
               ATE after it below the pre-fusion ATE and within 5 cm of the
               JAX package's CPU run (20.20 cm); Fuser.fuse (30 masked-Adam
               steps of 2^19 points drawn on the card from the mapping pool,
               features 1e-3, submap and keyframe poses 1e-4), the ATE after
               it within 5 cm of the JAX run's (19.44 cm); consolidated_grid
               of the fused atlas over the padded world box, its node
               features against the atlas query (1e-5), the fused-vs-atlas
               |dSDF| at 2^16 points, the fused grid meshed at 128^3 and its
               metrics at 10 cm against the GT in the system frame,
               Chamfer_L1 within 25 % of the JAX package's CPU run (22.54 cm);
               per-frame times and one frame's idle share as in phase 5;
               launches exact throughout;
  7. align   - demo/align_submaps.py --method miso --use_sdf through the
               port: room_scene(6.0) with a box and an icosphere, an
               8 -> 32 -> 1 decoder pretrained 250 epochs on the scene and
               fixed, 2 submaps (6 x 6 x 3.6 m, 0.75 m / 0.15 m cells, F=4)
               centred at x = -1.5 and +1.5, each trained 250 epochs of
               tsdf_loss_3d on its own samples; submap 1 moved by 3 degrees
               and 15 cm (numpy default_rng(0)); the hierarchical alignment
               (latent levels 0 and 1, then the SDF finetune, 150 iterations
               each, lr 5e-3, L2, every vertex over the norm threshold); the
               submap poses' rotation and translation RMSE before and after,
               which must end under a third of the perturbation and within
               0.3 degrees and 1.5 cm of the JAX package's CPU run of the
               demo (0.360 degrees, 1.22 cm); per iteration one slot-id
               forward and one points-only backward a level (and a decode in
               the SDF finetune), exact; then, each from a copy of the
               trained atlas taken before the perturbation and with the same
               perturbation (align_baselines): (b) --method vfpp and (c)
               --method mips (8192 observations a submap in its frame, 4096
               drawn a step, 150 iterations at lr 5e-3), (d) --method icp
               (near-surface points of a 48^3 lattice, point-to-plane ICP, a
               100-iteration pose graph), (e) InfoNCE alignment (latent
               levels 0 and 1, 4096 points a pair a step, 150 iterations a
               level, no SDF finetune); each within 0.3 degrees (InfoNCE
               0.36, from the card's spread) and 1.5 cm (icp 2 cm) of the
               JAX package's CPU run of the same
               (scripts/jax_align_baselines.py), vfpp and mips under a third
               of the perturbation, icp under it; the first step of (b),
               (c), (e) against a CPU copy of the atlas (loss 1e-4 relative,
               pose gradient 1e-4 of its largest entry); launches exact;
  8. encode  - encoder initialization through the port: (a) demo/encoder_init.py
               at its defaults (encoder_init_demo), from the JAX package's
               random draws of the demo (ENC_DRAWS: the decoder's and the
               encoders' initial parameters, the camera poses): a decoder
               pretrained 250 epochs on room_scene(4.0, seed 1), per-level
               encoders pretrained 250 steps a level (pretrain_encoders:
               masked Adam on the target level) on 3 noisy PosedSdf3D rooms of
               32 frames, then on the unseen room_scene(5.0) the zero and the
               encoder init, each followed by K = 0, 5, 15, 50
               optimize_grid_net epochs of the iSDF loss; the SDF MAE after
               each, the encoder init's at K=0 under half the zero init's and
               every reading within 30 % of the JAX package's CPU run of the
               demo (JAX_ENC_*); the one-shot encoder ms
               (CUDA-synchronized) and the pretraining seconds; (b) the
               in-system recipe of tests/test_encoder_system.py
               (encoder_system_setup, encoder_system_run): a 12-frame orbit,
               2 submaps of 6 keyframes, LM tracking, from the JAX package's
               draws of the recipe (ENCSYS_DRAWS: its pretrained decoder,
               the encoders' initial parameters, the camera poses), encoders
               pretrained 60 steps a level on two rooms, System at zero@30,
               zero@10 and encode@10 init iterations; encode@10's map error
               under 1.15 x zero@30's and 0.9 x zero@10's, one encoder init
               per submap and no grid left registered; (c) phase 6's quad run with
               --init_mode encode (phase_quad_encode): encoders pretrained as
               the demo's pretrain_encoders_synthetic does (2 held-out quad
               scenes, 150 steps a level), every submap encoder-initialized
               with a 33-iteration init burst; the pre-fusion ATE within 5 cm
               of the JAX package's CPU run (11.93 cm) and beside phase 6's
               zero-init reading, the encoder ms per spawn and the spawn's
               parts; no Fuser.  Launches exact everywhere: per residual pass
               one interp forward per level and one decode, per pretraining
               step one table-only interp backward;
  9. alt     - the paper's comparison models at the JAX package's default
               widths (alt_model_cfg), each built through the config
               registry and trained on phase 4's scene and batches
               (tsdf_loss_3d without the eikonal, the base Trainer with Adam,
               300 epochs): iSDF (256 wide, softplus, float32 products), the
               Instant-NGP hash grid (8 levels x F=2, 2^19 rows), PointSDF
               (50,000 support points, kNN of 8, 0.1 m voxel hash) and a VM
               GridNet (phase 4's widths, rank 10); the first step against a
               CPU copy (loss and largest gradient entry 1e-5 relative,
               PointSDF's forward 1e-5), the step's CUDA-event times, a
               profiled step (device time, idle share, its largest kernels),
               the 128^3 mesh's F-score within 5 points and Chamfer_L1 within
               25 % of the JAX package's CPU run (scripts/jax_alt_models.py,
               JAX_ALT); then a 2D GridNet on a 512 x 512 occupancy image
               (Sdf2D, the Sdf2D loss entry, 150 epochs), its MAE over the
               image within 30 % of the JAX CPU run's; the decode kernel once
               per forward of the hash grid, VM and 2D models, never for iSDF
               and PointSDF, and no interp kernel in the whole phase, exact;
 10. bf16    - bf16 feature storage and the apps: (a) every path a bf16
               table takes through the interp and fused kernels against
               its plain version on the same table (phase_bf16_kernels: the
               ScanNet levels with 1e6 points, staged, paired and L2 forwards,
               padded storage, F = 1, 3, 4, 12, 0 and 1 points, the slot-id
               cases, all three backward modes; values 1e-4, a bf16 table's
               gradient the float32 one rounded once: half a bf16 step plus
               1e-4 of the largest entry), a float16 table and mixed levels
               refused, bf16 times beside float32's with bounds at 2 bytes an
               element and grid_sample on a bf16 volume; (b) the
               test_bf16_features recipe trained on the card (MAE under 0.03
               and within 30 % of the JAX CPU run, scripts/jax_apps.py);
               (c) the demo CLIs (miso_tpu_torch.demo): build_submaps
               --synthetic at its defaults (the final mesh's F-score within
               5 points and Chamfer_L1 within 25 % of the JAX CPU run's),
               align_submaps --atlas on its grid_atlas.npz with --method miso
               --use_sdf (pose errors within 25 % of the JAX CPU run's: that
               atlas does not realign in either package) and align_submaps
               --method miso --use_sdf on its synthetic atlas (pose errors
               under a third of the perturbation), the other three at a
               small depth (finite readings, kernels launched); (d) phase 6's fused grid meshed from bf16 storage
               (F-score within 0.5 points of float32's, lattice within 0.02
               of the field's scale, the 512^3 field timed in both dtypes)
               and a live view (slam/live_viewer.py) over a bf16 System run
               of two submaps, /state.json read back, then the submaps
               aligned and meshed on bf16 storage;
     report  - the card, step times, kernel times against the bound, and the
               kernels line (each kernel's launches summed over phase 3's
               default-decode run, phases 4 to 10; the fused kernel's in phase
               3's fused run; each kernel's max_abs_err over its float32 and
               bf16 checks, its bf16 times beside); the last line is
               {"ok": true, "device": ...}.

Phase 2 also holds the atlas queries (query_feature, query_stability,
__call__) over 3 live slots of mixed bounds (padded storage) at the ScanNet
widths and 2^20 world points to the same queries on the plain ops, with
exact launches (one interp forward per live slot and level), and times them
beside the sum of their kernels' calls; and the interp kernels' slot-id mode
(each point against its own slot of an atlas level's stacked storage: the
forward, the backward with the table's and points' gradients, the table's
alone, and the points-only backward) against its plain version at phase 6's
alignment level (2 x 220 x 220 x 47 x 4, 8192 points), phase 7's fine level
(2 x 40 x 40 x 24 x 4, 38,400 points), mixed logical sizes below the storage
at F = 1, 3 and 4 with points outside their bounds, and 0 and 1 points,
timing the forward and the points-only backward at the first two.

Imports torch, numpy, scipy and miso_tpu_torch only.
Needs one CUDA card.
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
    weights; a table at its element size).  The FP32 bound counts every FMA
    on the CUDA cores."""
    n = x.shape[0]
    fdim = grids[0].shape[-1]
    t_tc, t_dot = _mlp_op_ms(decoder, n)
    lerp_flops = 2.0 * 8 * len(grids) * fdim * n
    t_ops = max(t_tc, t_dot + lerp_flops / PEAK_FP32_FLOPS * 1e3)
    nbytes = ((x.numel() + n * decoder[-1][0].shape[1]
               + sum(W.numel() + b.numel() for W, b in decoder)) * 4
              + sum(g.numel() * g.element_size() for g in grids))
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
    feature, twice with the points' gradient.  The table (and its gradient)
    at its element size: 4 bytes, or 2 in bf16."""
    n, fdim = x.shape[0], grid.shape[-1]
    table = grid.numel() * grid.element_size()
    nbytes = (x.numel() + n * fdim + 6) * 4 + table
    flops = 2.0 * 8 * fdim * n
    if need_x:
        nbytes += table + 3 * n * 4
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

# The atlas query (phase 2): 3 live slots of mixed bounds at the ScanNet
# widths, so that two are padded, at these world poses.
ATLAS_POINTS = 2 ** 20
ATLAS_SUBMAPS = [
    (SCANNET_MODEL["grid"]["bound"], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    ([[-0.02, 6.38], [-0.01, 5.24], [-0.01, 3.03]], [0.0, 0.0, 0.3], [2.0, 1.0, 0.0]),
    ([[-1.0, 7.0], [-2.0, 2.5], [-0.5, 2.0]], [0.05, 0.0, -0.4], [-1.0, 3.0, 0.2]),
]


def build_query_atlas(device, seed=80):
    """A GridAtlas of configs/rgbd/scannet.yaml's model (its grid and its
    decoder's widths, random weights) and capacity with ATLAS_SUBMAPS, random
    features (0.1 N(0, 1)), stability in [0, 1) and small pose corrections
    on the live slots."""
    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.ops import se3
    cfg = load_config(os.path.join(ROOT, "configs", "rgbd", "scannet.yaml"))
    cfg["model"]["decoder"]["pretrained_model"] = None
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=4,
                      capacity=cfg["system"]["submap_capacity"], device=device)
    for bound, rot, shift in ATLAS_SUBMAPS:
        R = se3.so3_exp(torch.tensor(rot, dtype=torch.float32)).numpy()
        atlas.add_submap(np.asarray(bound, np.float32), Rws=R, tws=np.asarray(shift, np.float32))
        atlas.add_kf()
    gen = torch.Generator(device=device).manual_seed(seed)
    p, S = atlas.params, atlas.num_submaps
    with torch.no_grad():
        for f in p.features:
            f[:S] = 0.1 * torch.randn(f[:S].shape, generator=gen, device=device)
        for st in p.stability:
            st[:S] = torch.rand(st[:S].shape, generator=gen, device=device)
        p.sub_rot_corr[:S] = 0.01 * torch.randn((S, 3), generator=gen, device=device)
        p.sub_trans_corr[:S] = 0.01 * torch.randn((S, 3), generator=gen, device=device)
    # Storage padded beyond each smaller slot's logical size.
    check(all(tuple(sz[s].tolist()) != pad for sz, pad in zip(p.sizes, p.pad_spatial)
              for s in (1, 2)), "the atlas query's slots 1 and 2 are not padded")
    return atlas


def phase_atlas_query():
    """The atlas queries (query_feature, query_stability, __call__) on the
    card against the same queries on the plain ops on the card: 3 live slots
    of mixed bounds at the ScanNet widths, 2^20 world points; exact launches
    per call (one interp forward per live slot and level, one decode for
    __call__); times per call beside the sum of their per-slot interp calls
    (and the decode call)."""
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.ops.fused_decode import mlp_decode_cuda, mlp_decode_plain
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda, grid_interpolate_plain
    dev = torch.device("cuda")
    atlas = build_query_atlas(dev)
    p = atlas.params
    b = torch.as_tensor(atlas.global_bound(), device=dev)
    x = _points(b, ATLAS_POINTS, torch.Generator(device=dev).manual_seed(81), out_frac=0.05)
    S, L = p.num_submaps, p.num_levels
    errs, times = {}, {}
    counters = kernel_counters()
    queries = {
        "query_feature": (lambda: p.query_feature(x),
                          lambda: p.query_feature(x, interpolate=grid_interpolate_plain),
                          p.features, dict(interp=L * S, decode=0)),
        "query_stability": (lambda: p.query_stability(x),
                            lambda: p.query_stability(x, interpolate=grid_interpolate_plain),
                            p.stability, dict(interp=L * S, decode=0)),
        "forward": (lambda: p(x),
                    lambda: p(x, interpolate=grid_interpolate_plain, decode=mlp_decode_plain),
                    p.features, dict(interp=L * S, decode=1)),
    }
    R, t = p.updated_submap_poses()
    xs = [se3.transform_points_from(x, R[s], t[s]).contiguous() for s in range(S)]
    decoder = tuple((W.detach(), bb.detach()) for W, bb in p.decoder)
    with torch.no_grad():
        feats = p.query_feature(x)
        for name, (fast, plain, tables, per_call) in queries.items():
            _zero_counts(counters)
            got = fast()
            torch.cuda.synchronize()
            c = _read_counts(counters)
            for k, n in dict(per_call, interp_grad=0, interp_points_grad=0, fused=0).items():
                check(c[k] == n, f"atlas {name}: {k} launched {c[k]} times, expected {n} "
                      f"({S} live slots, {L} levels)")
            _check_values(f"atlas_{name}", got, plain(), errs)
            parts = sum(cuda_ms(lambda s=s, l=l: grid_interpolate_cuda(
                tables[l][s], xs[s], p.bounds[s], p.sizes[l][s])) for s in range(S)
                for l in range(L))
            if per_call["decode"]:
                parts += cuda_ms(lambda: mlp_decode_cuda(decoder, feats))
            times[name] = dict(ms=cuda_ms(fast), plain_ms=cuda_ms(plain), parts_ms=parts,
                               points=ATLAS_POINTS, live_slots=S, launches=c)
            log(f"  atlas {name}: {ATLAS_POINTS} points, {S} live slots of capacity "
                f"{p.capacity}: {times[name]['ms']:.4f} ms a call (its kernels alone "
                f"{parts:.4f}), plain ops {times[name]['plain_ms']:.4f} ms; launches {c}")
    times["pad_spatial"] = [list(v) for v in p.pad_spatial]
    times["sizes"] = [sz[:S].tolist() for sz in p.sizes]
    return errs, times


# The slot-id mode's cases, (name, padded storage (S, X, Y, Z), F, logical
# sizes, points): phase 6's alignment level (two quad LiDAR slots of 220 x 220
# x 47 float4 rows, the same logical sizes) at the 8192 points a pair that its
# alignment subsamples; the align phase's fine level (40 x 40 x 24) at 38,400
# points; mixed logical sizes below the storage at F = 1 (stability), 3 (not a
# multiple of 4) and 4; and 0 and 1 points.
QUAD_PAD = (220, 220, 47)
SLOT_CASES = [
    ("quad_fine_F4", (2, *QUAD_PAD), 4, [QUAD_PAD] * 2, 8192),
    ("align_fine_F4", (2, 40, 40, 24), 4, [(40, 40, 24)] * 2, 38400),
    ("mixed_F4", (3, 40, 40, 24), 4, [(40, 40, 24), (30, 36, 20), (12, 40, 7)], 100000),
    ("mixed_F1", (3, 40, 40, 24), 1, [(40, 40, 24), (30, 36, 20), (12, 40, 7)], 100000),
    ("mixed_F3", (3, 40, 40, 24), 3, [(40, 40, 24), (30, 36, 20), (12, 40, 7)], 100000),
    ("mixed_F4_n0", (3, 40, 40, 24), 4, [(40, 40, 24), (30, 36, 20), (12, 40, 7)], 0),
    ("mixed_F4_n1", (3, 40, 40, 24), 4, [(40, 40, 24), (30, 36, 20), (12, 40, 7)], 1),
]


def slot_case(pad, F, sizes, n, seed):
    """Stacked storage, slot ids, points (each about its own slot's bound, a
    tenth outside it), bounds (S, 3, 2) of different extents, int32 sizes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = pad[0]
    stacked = 0.1 * torch.randn((*pad, F), generator=gen, device=dev)
    lo = -20.0 - 10.0 * torch.rand((S, 3), generator=gen, device=dev)
    bounds = torch.stack([lo, lo + 30.0 + 20.0 * torch.rand((S, 3), generator=gen, device=dev)],
                         -1).contiguous()
    ids = torch.randint(0, S, (n,), generator=gen, device=dev, dtype=torch.int32)
    b = bounds[ids.long()]
    ext = b[..., 1] - b[..., 0]
    x = (b[..., 0] - 0.05 * ext + torch.rand((n, 3), generator=gen, device=dev) * 1.1 * ext)
    return (stacked, ids, x.contiguous(), bounds,
            torch.tensor(sizes, dtype=torch.int32, device=dev))


def _slot_rows_touched(stacked, ids, x, bounds, sizes):
    """Distinct table rows the points' corners read with a nonzero weight (the
    bytes bound reads each once)."""
    from miso_tpu_torch.ops.interp import per_point_corner_indices_and_weights
    lin, w = per_point_corner_indices_and_weights(ids, x, bounds, sizes, stacked.shape[1:4])
    return int(torch.unique(lin[w != 0]).numel())


def _slot_bounds(stacked, ids, x, bounds, sizes, points_only):
    """(ms, "bytes") of one slot-id call: each touched row of F elements read
    once (4 or 2 bytes each), and per point its 12 B, its 4 B id and its
    output (4F B) or, for the points-only backward, its cotangent (4F B) and
    gradient (12 B)."""
    n, F = x.shape[0], stacked.shape[-1]
    nbytes = (_slot_rows_touched(stacked, ids, x, bounds, sizes) * stacked.element_size() * F
              + n * (16 + 4 * F))
    if points_only:
        nbytes += 12 * n
    return _bound(nbytes, 2.0 * 8 * F * n * (2 if points_only else 1))


def phase_slot_kernels():
    """The interp kernels' slot-id mode (each point against its own slot of an
    atlas level's stacked storage) against its plain version: the forward,
    the backward with the table's and the points' gradients, with the table's
    alone, and the points-only backward, at SLOT_CASES; their times at the
    quad alignment's shape beside the plain version's and the bytes bound."""
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_per_point_cuda, grid_interpolate_per_point_grad_cuda,
        grid_interpolate_per_point_grad_plain, grid_interpolate_per_point_plain)
    errs, times = {}, {}
    for i, (name, pad, F, sizes, n) in enumerate(SLOT_CASES):
        args = slot_case(pad, F, sizes, n, 120 + i)
        stacked, ids, x, bounds, sz = args
        got = grid_interpolate_per_point_cuda(stacked, ids, x, bounds, sz)
        ref = grid_interpolate_per_point_plain(stacked, ids, x, bounds, sz)
        check(got.shape == (n, F), f"slot_{name}: output {tuple(got.shape)}")
        if n:
            _check_values(f"slot_{name}", got, ref, errs)
            outside = ~torch.all((x >= bounds[ids.long(), :, 0]) & (x <= bounds[ids.long(), :, 1]),
                                 dim=-1)
            check(n < 100 or bool(outside.any()), f"slot_{name}: no point outside its bound")
        gen = torch.Generator(device=x.device).manual_seed(200 + i)
        cot = torch.randn((n, F), generator=gen, device=x.device)
        d_st, d_x = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot)
        r_st, r_x = grid_interpolate_per_point_grad_plain(stacked, ids, x, bounds, sz, cot)
        _check_grad(f"slot_grad_{name}_table", d_st, r_st, errs)
        only, none = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot,
                                                          need_x=False)
        check(none is None, "need_x=False returned a points' gradient")
        _check_grad(f"slot_grad_{name}_table_only", only, r_st, errs)
        none, p_x = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot,
                                                         need_grid=False)
        check(none is None and p_x.shape == (n, 3), "points-only mode: wrong outputs")
        if n:
            _check_grad(f"slot_grad_{name}_points", d_x, r_x, errs)
            _check_grad(f"slot_points_only_{name}", p_x, r_x, errs)
        if name in ("quad_fine_F4", "align_fine_F4"):
            fwd_b = _slot_bounds(*args, points_only=False)
            bwd_b = _slot_bounds(*args, points_only=True)
            times[name] = dict(
                points=n, storage=list(pad) + [F],
                fwd=dict(ms=cuda_ms(lambda: grid_interpolate_per_point_cuda(*args)),
                         plain_ms=cuda_ms(lambda: grid_interpolate_per_point_plain(
                             stacked, ids, x, bounds, sz)),
                         bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None),
                points_only=dict(
                    ms=cuda_ms(lambda: grid_interpolate_per_point_grad_cuda(
                        stacked, ids, x, bounds, sz, cot, need_grid=False)),
                    plain_ms=cuda_ms(lambda: grid_interpolate_per_point_grad_plain(
                        stacked, ids, x, bounds, sz, cot, need_grid=False)),
                    bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None),
                table_and_points_ms=cuda_ms(lambda: grid_interpolate_per_point_grad_cuda(
                    stacked, ids, x, bounds, sz, cot)))
            t = times[name]
            # The kernels' own device time (a call's time is mostly the host's
            # launch at these sizes).
            t["fwd"]["device_ms"] = _kernel_device_ms(
                lambda: grid_interpolate_per_point_cuda(*args), "grid_interp_forward_kernel")
            t["points_only"]["device_ms"] = _kernel_device_ms(
                lambda: grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot,
                                                             need_grid=False),
                "grid_interp_points_grad_kernel")
            log(f"  slot-id mode {name} ({n} points, storage {list(pad) + [F]}): forward "
                f"{t['fwd']['ms']:.4f} ms a call, {t['fwd']['device_ms']:.4f} on the device "
                f"(plain {t['fwd']['plain_ms']:.4f}, bound {t['fwd']['bound_ms']:.4f}, bytes); "
                f"points-only backward {t['points_only']['ms']:.4f} ms a call, "
                f"{t['points_only']['device_ms']:.4f} on the device (plain "
                f"{t['points_only']['plain_ms']:.4f}, bound {t['points_only']['bound_ms']:.4f}); "
                f"table and points {t['table_and_points_ms']:.4f} ms")
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
    zeroes and reads: the interp backward counts its points-only mode apart,
    and the slot-id mode of both (``interp_slot*``) counts its own."""
    from miso_tpu_torch.ops.fused_decode import fused_interp_decode_cuda, mlp_decode_cuda
    from miso_tpu_torch.ops.tiled_interp import (
        grid_interpolate_cuda, grid_interpolate_grad_cuda, grid_interpolate_per_point_cuda,
        grid_interpolate_per_point_grad_cuda)
    return {"interp": (grid_interpolate_cuda, "launches"),
            "interp_grad": (grid_interpolate_grad_cuda, "launches"),
            "interp_points_grad": (grid_interpolate_grad_cuda, "points_launches"),
            "interp_slot": (grid_interpolate_per_point_cuda, "launches"),
            "interp_slot_grad": (grid_interpolate_per_point_grad_cuda, "launches"),
            "interp_slot_points_grad": (grid_interpolate_per_point_grad_cuda, "points_launches"),
            "decode": (mlp_decode_cuda, "launches"),
            "fused": (fused_interp_decode_cuda, "launches")}


def _zero_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp, _GridInterpPerPoint
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    _GridInterp.recomputes = 0
    _GridInterpPerPoint.recomputes = 0


def _read_counts(counters):
    from miso_tpu_torch.ops.tiled_interp import _GridInterp, _GridInterpPerPoint
    out = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    out["interp_recompute_backward"] = _GridInterp.recomputes
    out["interp_slot_recompute_backward"] = _GridInterpPerPoint.recomputes
    return out


# The slot-id counters, which every path but alignment leaves at 0.
SLOT_COUNTERS = ("interp_slot", "interp_slot_grad", "interp_slot_points_grad",
                 "interp_slot_recompute_backward")


def _exact(want):
    """A path's launch expectations with the slot-id counters it does not
    name at 0."""
    return {**{k: 0 for k in SLOT_COUNTERS}, **want}


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
    for name, per in _exact({**per_step, "interp_recompute_backward": 0}).items():
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
# Phase 5: demo/full_slam_scannet.py --synthetic: System and GridAtlas, the
# final refinement and the observed mesh.
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
# demo/full_slam_scannet.py's defaults: the refinement over every keyframe,
# the 256^3 observed mesh (stability above 0.2) and its metrics.
SLAM_FINAL_ITERS = 200
SLAM_MESH_RESOLUTION = 256
SLAM_STABILITY_THRESH = 0.2
# The JAX package's own CPU run of the same demo with its defaults
# (`JAX_PLATFORMS=cpu python demo/full_slam_scannet.py --synthetic`): F-score
# 62.210 %; the port's must come within 5 points of it.
JAX_CPU_FSCORE = 62.210134889670606
FSCORE_MARGIN = 5.0
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
    cfg["visualizer"] = {"enable": False}
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
                     batch=2 ** 13, total=2 ** 16, trunc_dist=0.3, bound=None,
                     decoder_init=None):
    """demo/full_slam_scannet.py::pretrain_decoder_synthetic: the decoder
    trained with a grid on the scene's SDF (over ``bound``, else the
    config's; a third of the epochs a level), then kept.  ``decoder_init``
    ((W, b), ...): the decoder's initial draw, else one from a generator
    seeded 7."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.train.trainer import GridTrainer
    ds = Sdf3D(mesh, batch_size=batch, total_samples=total, trunc_dist=trunc_dist)
    cfg = copy.deepcopy(cfg_model)
    cfg["decoder"].update({"fix": False, "pretrained_model": None})
    cfg["pose"] = {"optimize": False, "num_poses": 1}
    model = create_grid_net(cfg, bound=bound, generator=torch.Generator().manual_seed(7),
                            device=device)
    if decoder_init is not None:
        flat = [a for pair in decoder_init for a in pair]
        check(len(flat) == len(model.decoder), f"decoder_init has {len(flat)} arrays, the "
              f"model's decoder {len(model.decoder)}")
        with torch.no_grad():
            for p, v in zip(model.decoder, flat):
                p.copy_(torch.as_tensor(v))
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=trunc_dist)
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


def _stage_percentiles(summary, key):
    v = summary.get(key)
    return None if v is None else dict(median=v["median"], p90=v["p90"])


def run_online(cfg, ds, counters, final_iters=SLAM_FINAL_ITERS, ds_map=None,
               R0=None, label="the SLAM run", decoder=None, encoder=None):
    """The demo's System over the whole sequence on a GridAtlas of the
    config's capacity on the card (tracking ``ds``, mapping ``ds_map`` or
    ``ds``; the given ``decoder`` installed fixed, else the config's; the
    ``encoder`` handed to System for ``submap_init_mode: "encode"``), then,
    with ``final_iters``, its refinement over every keyframe (features, poses
    locked) and the sync of the atlas.  Returns the report, the world
    trajectory (n, 4, 4), the System and the atlas."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System
    from miso_tpu_torch.utils.profiling import breakdown
    dev = torch.device("cuda")
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"), device=dev)
    if decoder is not None:
        atlas.set_decoder(decoder, fixed=True)
    R0_, t0 = ds.noisy_kf_pose_in_world(0)
    R0 = R0_ if R0 is None else R0
    torch.cuda.synchronize()
    _zero_counts(counters)
    t_start = time.perf_counter()
    system = System(atlas, ds, ds_map or ds, cfg, R0, t0, verbose=False, encoder=encoder)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    # Step by step up to the last two frames, with the card's allocated
    # bytes and the mapping sequence's device pool after each step.
    ds_pool = ds_map or ds
    memory, pools = [], set()
    while atlas.num_keyframes < ds.num_kfs - 2:
        system.step()
        memory.append(torch.cuda.memory_allocated(dev))
        pools.add(id(getattr(ds_pool, "_pool", None)))
    # The last two frames: one unprofiled, one under torch.profiler.
    frame = breakdown("one frame of " + label, lambda n: [system.step() for _ in range(n)], 1)
    system.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_start
    counts = _read_counts(counters)
    refine_s, refine_counts = 0.0, None
    if final_iters:
        _zero_counts(counters)
        t0_ = time.perf_counter()
        system.mapper.mapping(list(range(ds.num_kfs)), iterations=final_iters,
                              level_iterations=max(final_iters // 3, 1))
        system.tracker.grid = system.mapper.grid
        system._sync_submap_from_tracker_mapper()
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0_
        refine_counts = _read_counts(counters)
    Rw, tw = system.kf_poses_in_world()
    T_est = np.stack([_pose(R, t) for R, t in zip(Rw, tw)])
    m = cfg["mapping"]
    prof = system.profile_summary()
    report = dict(frames=atlas.num_keyframes, submaps=atlas.num_submaps,
                  capacity=atlas.params.capacity, init_s=init_s, run_s=run_s,
                  launches=counts, refine_iters=final_iters, refine_s=refine_s,
                  refine_launches=refine_counts,
                  map_steps=m.get("init_iterations", 50)
                  + (ds.num_kfs - 1) * m.get("iters_per_frame", 15),
                  track_steps=(ds.num_kfs - 1) * 15,
                  track_ms=_stage_percentiles(prof, "track_ms"),
                  map_ms=_stage_percentiles(prof, "map_ms"),
                  spawn_ms=_stage_percentiles(prof, "submap_init_ms"),
                  frame_ms=_stage_percentiles(prof, "frame_ms"), profile=prof,
                  profiled_frame=frame, spawn_parts_ms=system.spawn_ms,
                  memory_after_step=memory, device_pools=len(pools))
    return report, T_est, system, atlas


def observed_mesh(atlas, resolution, thresh, counters):
    """The demo's final mesh: observed_sdf_query(atlas.params, thresh) over
    atlas.global_bound() at resolution^3; every lattice chunk must launch one
    interp forward per live slot and level for the features, as many for the
    stability, and one decode.  Returns (mesh, report)."""
    from miso_tpu_torch.utils.sdf import observed_sdf_query, save_mesh
    bound = atlas.global_bound()
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    mesh = save_mesh(observed_sdf_query(atlas.params, thresh), bound, None,
                     resolution=resolution)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = _read_counts(counters)
    chunks = -(-resolution ** 3 // MESH_CHUNK)
    per = 2 * atlas.num_levels * atlas.num_submaps
    want = {"interp": per * chunks, "decode": chunks, "interp_grad": 0,
            "interp_points_grad": 0, "fused": 0, "interp_recompute_backward": 0}
    for name, n in _exact(want).items():
        check(c[name] == n, f"observed mesh: {name} launched {c[name]} times in {chunks} "
              f"lattice chunks, expected {n} ({per} interp and 1 decode a chunk)")
    return mesh, dict(resolution=resolution, seconds=seconds, chunks=chunks, launches=c,
                      bound=bound.tolist(), vertices=int(len(mesh.vertices)))


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


def _log_frames(report, card):
    """The per-frame stage times of a System run, its spawns and its
    profiled frame."""
    f = report.get("profiled_frame") or {}
    spawns = [sum(p.values()) for p in report["spawn_parts_ms"]]
    log(f"  per frame (StageProfiler, CUDA-synchronized; {card}): track "
        f"{report['track_ms']['median']:.2f} ms median, {report['track_ms']['p90']:.2f} p90; "
        f"map {report['map_ms']['median']:.2f} median, {report['map_ms']['p90']:.2f} p90; "
        f"frame {report['frame_ms']['median']:.2f} median, {report['frame_ms']['p90']:.2f} p90; "
        f"spawns {', '.join(f'{v:.2f}' for v in spawns) or 'none'} ms"
        + (f"; one frame {f['wall_ms']:.2f} ms of wall time, {f['device_ms']:.2f} of device "
           f"time, idle share {f['idle_share']:.3f}" if f else ""))


def phase_slam(card):
    """demo/full_slam_scannet.py --synthetic through the port: the decoder
    pretrained and fixed, System on a GridAtlas (the init burst, then per
    frame odometry, Tracker.track (Adam) and a mapping burst); ATE against
    the ground truth and against the odometry alone; the 200-iteration
    refinement over every keyframe; the observed 256^3 mesh and its F-score
    against the JAX package's CPU run.  Then the LM run on the same sequence
    and model.  Launch counts exact for all; the kernels held to their plain
    versions at the path's shapes."""
    import tempfile

    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.train.checkpoint import save_pytree
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics, trajectory_error

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
        online, T_est, system, atlas = run_online(cfg, ds, counters,
                                                  label="demo/full_slam_scannet.py")
        mesh_pred, lattice = observed_mesh(atlas, SLAM_MESH_RESOLUTION, SLAM_STABILITY_THRESH,
                                           counters)
        lidar = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
        lm, tracker = run_lm_recovery(cfg, dict(lidar["tracking"]), ds, dev, counters)

    T_gt = np.stack([_pose(*ds.true_kf_pose_in_world(k)) for k in range(ds.num_kfs)])
    ate = trajectory_error(T_est, T_gt, align=True)
    ate_odom = trajectory_error(odometry_trajectory(ds), T_gt, align=True)
    t0 = time.perf_counter()
    recon = mesh_reconstruction_metrics(mesh_pred, mesh, n_points=100000, threshold=0.05,
                                        truncation=0.5)
    lattice["metrics_s"] = time.perf_counter() - t0
    online.update(ate=ate, ate_odometry_only=ate_odom, mesh=lattice, reconstruction=recon)
    c = online["launches"]
    log(f"  online: {online['frames']} frames in {online['submaps']} submap (capacity "
        f"{online['capacity']}), init burst {online['init_s']:.2f} s, run "
        f"{online['run_s']:.2f} s; launches {c}")
    _log_frames(online, card)
    log(f"  ATE RMSE {100 * ate['ate_rmse']:.3f} cm, rotation RMSE "
        f"{ate['rot_rmse_deg']:.4f} deg; odometry alone: ATE RMSE "
        f"{100 * ate_odom['ate_rmse']:.3f} cm, rotation RMSE {ate_odom['rot_rmse_deg']:.4f} deg")
    log(f"  refinement: {online['refine_iters']} iterations over {ds.num_kfs} keyframes in "
        f"{online['refine_s']:.2f} s ({card}); launches {online['refine_launches']}")
    log(f"  observed mesh {SLAM_MESH_RESOLUTION}^3 over the atlas's global bound: "
        f"{lattice['seconds']:.2f} s (lattice and marching cubes; {card}), {lattice['vertices']} "
        f"vertices; F-score {recon['F-score (%)']:.3f} % (the JAX package's CPU run "
        f"{JAX_CPU_FSCORE:.3f} %), Chamfer_L1 {recon['Chamfer_L1 (cm)']:.3f} cm; launches "
        f"{lattice['launches']}")
    check(online["submaps"] == 1 and online["frames"] == ds.num_kfs,
          f"{online['submaps']} submaps, {online['frames']} keyframes")
    check(ate["ate_rmse"] < ate_odom["ate_rmse"],
          f"ATE {ate['ate_rmse']:.4f} m not below the odometry's {ate_odom['ate_rmse']:.4f} m")
    check(ate["ate_rmse"] < MAX_ATE_M, f"ATE {ate['ate_rmse']:.4f} m not below {MAX_ATE_M} m")
    check(recon["F-score (%)"] >= JAX_CPU_FSCORE - FSCORE_MARGIN,
          f"F-score {recon['F-score (%)']:.3f} % more than {FSCORE_MARGIN} points under the "
          f"JAX package's {JAX_CPU_FSCORE:.3f} %")
    # Mapping (features and stability queried: 4 interp and 4 interp grad a
    # step) and Adam tracking (2 and 2) take the table-gradient backward.
    ms, ts = online["map_steps"], online["track_steps"]
    for what, counts, m_steps, t_steps in (("online run", c, ms, ts),
                                           ("refinement", online["refine_launches"],
                                            online["refine_iters"], 0)):
        want = {"interp": 4 * m_steps + 2 * t_steps, "interp_grad": 4 * m_steps + 2 * t_steps,
                "decode": m_steps + t_steps, "interp_points_grad": 0, "fused": 0,
                "interp_recompute_backward": 0}
        for name, n in _exact(want).items():
            check(counts[name] == n, f"{what}: {name} launched {counts[name]} times, expected "
                  f"{n} ({m_steps} mapping and {t_steps} tracking steps)")

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
    for name, n in _exact(want).items():
        check(c[name] == n, f"LM run: {name} launched {c[name]} times in {k} iterations, "
              f"expected {n}")

    log("  the slam path's kernels against their plain versions:")
    ds.select_keyframes([LM_KF])
    b = ds.sample(np.random.default_rng(72))
    R, t = tracker.grid.updated_kf_pose(LM_KF)
    lm_batch = se3.transform_points_to(torch.as_tensor(b["coords_frame"], device=dev),
                                       R, t).contiguous()
    errs, times = _slam_kernel_checks(system.mapper.grid, ds, tracker.grid, lm_batch)
    return dict(online=online, lm=lm, points_only=times), errs


# ---------------------------------------------------------------------------
# Phase 6: two-submap online SLAM (demo/full_slam_newer_college.py --synthetic
# --scene quad --num_frames 60 --submap_size 30) through its Fuser; then the
# fused atlas consolidated into one grid and meshed.
# ---------------------------------------------------------------------------

QUAD_FRAMES = 60
QUAD_SUBMAP_SIZE = 30
QUAD_MESH_RESOLUTION = 128
QUAD_COMPARE_POINTS = 2 ** 16
QUAD_NODE_CHECK = 2 ** 16        # fused-grid nodes held to the atlas query, per level
QUAD_CHUNK = 2 ** 18             # consolidated_grid's chunk of nodes
QUAD_FSCORE_THRESH = 0.10        # demo/full_slam_newer_college.py:646-648
# The JAX package's run of the same configuration on the CPU through its
# Fuser (scripts/jax_quad_prefusion.py --fuse): pre-fusion ATE 29.05 cm
# against the odometry's 14.21 cm (the submaps are each tracked better than
# the odometry, 4.11 cm against 4.93 cm, and the second sits at its anchor's
# drift from the first until the Fuser aligns them), 20.20 cm after the
# alignment and 19.44 cm after the fuse; the fused atlas's 128^3 mesh at
# Chamfer_L1 22.54 cm, F-score 5.90 % at 10 cm.  Its TPU run read 28.50 cm
# before fusion (results/smoke_quad6/results.json, older code).  The port is
# held to the CPU run's figures with margins of 5 cm of ATE and 25 % of
# Chamfer_L1.  The card's readings vary from run to run because the online
# run does (float atomics in the kernels' backward change the trajectory:
# 28.1-29.3 cm before fusion); the Fuser on copies of one atlas repeats to
# 1e-6 cm (scripts/quad_fusion_spread.py).  Six runs on an NVIDIA H100 80GB
# HBM3 at 700 W read 17.06-19.80 cm after the alignment (mean 18.76, standard
# deviation 1.00) and 16.46-19.49 cm after the fuse (18.54, 1.19): the lower
# limits, 15.20 and 14.44 cm, sit 3.6 and 3.5 deviations below the means, the
# upper ones more than 5 above; Chamfer_L1 read 22.55-22.63 cm against a
# margin of 5.6 cm.
JAX_QUAD_ATE_M = 0.2904777929399223
JAX_QUAD_POSTALIGN_ATE_M = 0.20197931963346055
JAX_QUAD_POSTFUSE_ATE_M = 0.19437506935875948
JAX_QUAD_CHAMFER_CM = 22.54001415723767
JAX_QUAD_FSCORE = 5.896331722208091
QUAD_ATE_MARGIN_M = 0.05
QUAD_MAX_ATE_M = JAX_QUAD_ATE_M + QUAD_ATE_MARGIN_M
QUAD_MAX_CHAMFER_CM = 1.25 * JAX_QUAD_CHAMFER_CM
# demo/full_slam_newer_college.py:443-456 over the config's align: section,
# and its fuse (:561-562).
QUAD_ALIGN = {"level_iters": 50, "finetune_iters": 50, "skip_finetune": False,
              "learning_rate": 2e-3, "subsample_points": 8192}
QUAD_FUSE = dict(feat_lr=1e-3, submap_pose_lr=1e-4, kf_pose_lr=1e-4, iterations=30)
QUAD_FUSE_POINTS = 2 ** 19


def quad_setup():
    """demo/full_slam_newer_college.py:266-342 for ``--synthetic --scene
    quad``: the 40 m courtyard toured by a LiDAR (192 x 64 rays), a sparse
    surface-only tracking sequence (0.6 m voxels) and a dense mapping one
    (0.1 m voxels, near-surface, free-space and behind-surface samples),
    configs/lidar/ncd_quad.yaml with the demo's overrides (axis-aligned
    submaps that each cover the whole site's world box).  Returns (the GT
    mesh, the GT mesh in the system frame, ds_track, ds_map, cfg, the world
    box)."""
    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.datasets.sequence import SdfSequence, circuit_trajectory
    from miso_tpu_torch.datasets.shapes import quad_scene
    from miso_tpu_torch.native import TriangleMesh
    verts, tris = quad_scene(40.0, seed=0, path_half_extent=14.0)
    mesh = TriangleMesh(verts, tris)
    R, t = circuit_trajectory(14.0, 1.5, QUAD_FRAMES, laps=1.0, wobble=0.3)
    scan = dict(scan_pattern="lidar", width=192, height=64)
    # The site box in the system frame (identity rotation at the first pose).
    t0 = t[0] + 0.0
    v_sys = (verts - t0) @ R[0] + t0
    world_bound = np.stack([v_sys.min(0) - 1.0, v_sys.max(0) + 1.0], axis=1)
    bound = (world_bound - world_bound.mean(axis=1, keepdims=True)).tolist()
    noise = dict(odom_std_rad=0.002, odom_std_meter=0.01)
    ds_track = SdfSequence(mesh, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                           trunc_dist=0.5, surface_only=True, voxel_size=0.6, **noise, **scan)
    ds_map = SdfSequence(mesh, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                         trunc_dist=0.5, near_surface_n=2, near_surface_std=0.25,
                         free_space_n=1, behind_surface_n=1, voxel_size=0.1, **noise, **scan)
    cfg = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
    cfg["system"].update({"submap_size": QUAD_SUBMAP_SIZE, "submap_local_bound": bound,
                          "submap_axis_aligned": True, "submap_world_bound": world_bound.tolist(),
                          "profile": True})
    cfg["model"]["grid"].update({"base_cell_size": 1.0, "per_level_scale": 5.0, "bound": bound})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None, "hidden_dim": 32})
    cfg["model"]["pose"]["num_poses"] = max(QUAD_SUBMAP_SIZE, 100)
    cfg["mapping"].update({"trunc_dist": 0.5, "finite_diff_eps": 0.1, "eik_trunc_dist": 0.5,
                           "weight_fs": 0.3, "learning_rate": 3e-3, "loss_type": "L2",
                           "iters_per_frame": 15, "level_iters_per_frame": 5,
                           "init_iterations": 100, "mask_bound": 1.0})
    cfg["tracking"].update({"solver": "lm", "loss_type": "GM", "gm_scale_sdf": 0.2,
                            "lm_max_iter": 16, "trunc_dist": 0.5, "lm_tol_deg": 0.005,
                            "lm_tol_m": 0.001})
    cfg["visualizer"] = {"enable": False}
    return (mesh, TriangleMesh(v_sys.astype(np.float32), tris), ds_track, ds_map, cfg,
            world_bound)


def submap_ate(T_est, T_gt, submap_of_kf):
    """ATE RMSE within the submaps: each submap's keyframes aligned to the
    ground truth on their own (Umeyama), the errors pooled over every
    keyframe.  Returns {'ate_rmse', 'per_submap'}."""
    from miso_tpu_torch.utils.eval import trajectory_error
    sub = np.asarray(submap_of_kf)
    per, sq = [], 0.0
    for s in range(int(sub.max()) + 1):
        rmse = trajectory_error(T_est[sub == s], T_gt[sub == s], align=True)["ate_rmse"]
        per.append(rmse)
        sq += rmse ** 2 * int((sub == s).sum())
    return dict(ate_rmse=float(np.sqrt(sq / len(sub))), per_submap=per)


def consolidate_and_compare(atlas, mesh_bound, counters):
    """consolidated_grid(bound=mesh_bound) with exact launches (per chunk of
    each level's nodes, one interp forward per live slot and level for the
    features and as many for the stability); its node features against
    atlas.query_feature at the node centres (exact by construction, 1e-5);
    the fused-vs-atlas |dSDF| at random points in the bound."""
    from miso_tpu_torch.models.grid_atlas import node_centres
    from miso_tpu_torch.ops.interp import grid_shape_for_bound
    p = atlas.params
    dev, L, S, F = atlas.device, atlas.num_levels, atlas.num_submaps, p.fdim
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    fused = atlas.consolidated_grid(chunk=QUAD_CHUNK, bound=mesh_bound)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = _read_counts(counters)
    chunks = sum(-(-int(np.prod(f.shape[:3])) // QUAD_CHUNK) for f in fused.features)
    want = dict(interp=2 * L * S * chunks, decode=0, interp_grad=0, interp_points_grad=0,
                fused=0, interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(c[name] == n, f"consolidation: {name} launched {c[name]} times in {chunks} "
              f"chunks, expected {n}")
    node_err = 0.0
    gen = torch.Generator().manual_seed(90)
    with torch.no_grad():
        for level, f in enumerate(fused.features):
            shape = f.shape[:3]
            cell = atlas.params.cell_sizes[level]
            check(tuple(shape) == grid_shape_for_bound(mesh_bound, cell),
                  f"fused level {level}: shape {tuple(shape)}")
            nodes = int(np.prod(shape))
            idx = torch.randint(0, nodes, (min(QUAD_NODE_CHECK, nodes),), generator=gen).to(dev)
            centres = node_centres(mesh_bound, shape, dev)[idx]
            _zero_counts(counters)
            ref = p.query_feature(centres)[:, level * F:(level + 1) * F]
            got = f.reshape(-1, F)[idx]
            n = _read_counts(counters)["interp"]
            check(n == L * S, f"node check: {n} interp launches, expected {L * S}")
            err = float((got - ref).abs().max())
            node_err = max(node_err, err)
            check(torch.allclose(got, ref, atol=1e-5, rtol=1e-5),
                  f"fused level {level}: node features off the atlas query by {err:.3e}")
        r = np.random.default_rng(0)
        pts = torch.as_tensor(r.uniform(mesh_bound[:, 0], mesh_bound[:, 1],
                                        (QUAD_COMPARE_POINTS, 3)).astype(np.float32), device=dev)
        _zero_counts(counters)
        sa = p(pts)
        sf = fused(pts)
        cc = _read_counts(counters)
        check(cc["interp"] == L * S + L and cc["decode"] == 2,
              f"field comparison: launches {cc}, expected {L * S + L} interp and 2 decode")
        dd = (sa - sf).abs().reshape(-1).cpu().numpy()
    return fused, dict(seconds=seconds, chunks=chunks, launches=c,
                       fused_shapes=[list(f.shape[:3]) for f in fused.features],
                       node_max_abs_err=node_err,
                       sdf_error=dict(mean_abs=float(dd.mean()),
                                      p99_abs=float(np.quantile(dd, 0.99)),
                                      max_abs=float(dd.max())))


def fused_mesh(fused, mesh_bound, counters, feature_dtype=None):
    """save_mesh of the fused grid at QUAD_MESH_RESOLUTION^3 (its storage cast
    to ``feature_dtype`` when given): per lattice chunk one interp forward per
    level and one decode."""
    from miso_tpu_torch.utils.sdf import save_mesh
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    mesh = save_mesh(fused, mesh_bound, None, resolution=QUAD_MESH_RESOLUTION,
                     feature_dtype=feature_dtype)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = _read_counts(counters)
    chunks = -(-QUAD_MESH_RESOLUTION ** 3 // MESH_CHUNK)
    want = dict(interp=fused.num_levels * chunks, decode=chunks, interp_grad=0,
                interp_points_grad=0, fused=0, interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(c[name] == n, f"fused mesh: {name} launched {c[name]} times, expected {n}")
    return mesh, dict(resolution=QUAD_MESH_RESOLUTION, seconds=seconds, chunks=chunks,
                      launches=c, vertices=int(len(mesh.vertices)))


def fuse_quad(atlas, ds_map, ds_track, cfg, counters, T_gt, ate_pre, card):
    """demo/full_slam_newer_college.py:539-565: the Fuser's alignment with
    QUAD_ALIGN over the config's align: section (latent level 1, L2, 32768
    alignment points a submap and level, 8192 a pair an iteration), then its
    fuse (QUAD_FUSE, 2^19 points a step); the ATE and rotation RMSE after
    each.  Gates: the ATE after the alignment below the pre-fusion ATE, and
    after the alignment and after the fuse within QUAD_ATE_MARGIN_M of the
    JAX package's CPU run.  Launches exact in both."""
    from miso_tpu_torch.slam.fuser import Fuser
    from miso_tpu_torch.utils.eval import trajectory_error

    def ate():
        Rw, tw = system_poses(atlas)
        T = np.stack([_pose(R, t) for R, t in zip(Rw, tw)])
        return trajectory_error(T, T_gt, align=True)

    cfg = copy.deepcopy(cfg)
    cfg["align"].update(QUAD_ALIGN)
    c = cfg["align"]
    fuser = Fuser(atlas, ds_map, cfg)
    L, S = atlas.num_levels, atlas.num_submaps
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    info = fuser.align()
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    align_c = _read_counts(counters)
    ate_align = ate()
    # Capped alignment coordinates: each submap's vertices of each level in
    # chunks of 2^19, L single-grid forwards a chunk; per step L slot-id
    # forwards and L points-only backwards (a decode per SDF step); the source
    # terms once a stage.
    chunks = sum(-(-int(np.prod(atlas.submap_shapes(s)[l])) // (1 << 19))
                 for s in range(S) for l in range(L))
    stages = len(c["latent_levels"]) + 1
    steps = c["level_iters"] + 1
    want = dict(interp=L * chunks, interp_slot=L * stages * (steps + 1),
                interp_slot_points_grad=L * stages * steps, decode=steps + 1, interp_grad=0,
                interp_points_grad=0, interp_slot_grad=0, fused=0,
                interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(align_c[name] == n, f"quad alignment: {name} launched {align_c[name]} times, "
              f"expected {n}")
    _zero_counts(counters)
    t0 = time.perf_counter()
    loss = fuser.fuse(max_points_per_iter=QUAD_FUSE_POINTS, **QUAD_FUSE)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    fuse_c = _read_counts(counters)
    ate_fuse = ate()
    # Per step the atlas's world query: one interp forward and one backward
    # (table and points) per live slot and level, one decode.
    k = QUAD_FUSE["iterations"]
    want = dict(interp=L * S * k, interp_grad=L * S * k, decode=k, interp_points_grad=0,
                fused=0, interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(fuse_c[name] == n, f"quad fuse: {name} launched {fuse_c[name]} times, expected {n}")
    report = dict(align_s=align_s, fuse_s=fuse_s, align_launches=align_c, fuse_launches=fuse_c,
                  ate_postalign=ate_align, ate_postfuse=ate_fuse, fuse_loss=loss,
                  fuse_info=fuser.last_fuse_info, align_precompute_s=info["precompute_sec"],
                  alignment_points=[int(atlas.alignment_coords_stacked(l)[0].shape[1])
                                    for l in range(L)])
    log(f"  Fuser: alignment {align_s:.2f} s (coordinates {info['precompute_sec']:.2f} s; "
        f"{report['alignment_points']} points a submap and level), ATE RMSE "
        f"{100 * ate_pre['ate_rmse']:.3f} -> {100 * ate_align['ate_rmse']:.3f} cm, rotation "
        f"RMSE {ate_pre['rot_rmse_deg']:.4f} -> {ate_align['rot_rmse_deg']:.4f} deg; fuse "
        f"{fuse_s:.2f} s ({QUAD_FUSE['iterations']} steps of {QUAD_FUSE_POINTS} points), ATE "
        f"RMSE {100 * ate_fuse['ate_rmse']:.3f} cm, rotation RMSE "
        f"{ate_fuse['rot_rmse_deg']:.4f} deg ({card}); the JAX package's CPU run "
        f"{100 * JAX_QUAD_POSTALIGN_ATE_M:.3f} and {100 * JAX_QUAD_POSTFUSE_ATE_M:.3f} cm; "
        f"launches: alignment {align_c}, fuse {fuse_c}")
    check(ate_align["ate_rmse"] < ate_pre["ate_rmse"],
          f"ATE after the alignment {ate_align['ate_rmse']:.4f} m not below the pre-fusion "
          f"{ate_pre['ate_rmse']:.4f} m")
    for label, got, ref in (("the alignment", ate_align, JAX_QUAD_POSTALIGN_ATE_M),
                            ("the fuse", ate_fuse, JAX_QUAD_POSTFUSE_ATE_M)):
        check(abs(got["ate_rmse"] - ref) < QUAD_ATE_MARGIN_M,
              f"ATE after {label} {got['ate_rmse']:.4f} m not within {QUAD_ATE_MARGIN_M} m of "
              f"the JAX package's CPU run ({ref:.4f} m)")
    return report


def system_poses(atlas):
    """World poses (R (n, 3, 3), t (n, 3)) of the atlas's keyframes, numpy."""
    with torch.no_grad():
        R, t = atlas.params.updated_kf_poses_in_world()
    n = atlas.num_keyframes
    return R[:n].cpu().numpy(), t[:n].cpu().numpy()


def phase_quad(card):
    """demo/full_slam_newer_college.py --synthetic --scene quad --num_frames
    60 --submap_size 30 through the port: the decoder
    pretrained (200 epochs) and fixed, System on a GridAtlas of the config's
    capacity (LM/GM tracking of 16 iterations, mapping bursts), exactly 2
    submaps and 60 keyframes; the ATE within the submaps under the
    odometry-only trajectory's and the whole pre-fusion ATE under
    QUAD_MAX_ATE_M; then the Fuser (fuse_quad); then consolidated_grid of the
    fused atlas over the padded world box, its nodes
    against the atlas query, the fused-vs-atlas |dSDF|, the 128^3 mesh of the
    fused grid and its metrics at 10 cm against the GT in the system frame,
    Chamfer_L1 under QUAD_MAX_CHAMFER_CM.  Launch counts exact throughout."""
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics, trajectory_error
    dev = torch.device("cuda")
    counters = kernel_counters()
    t0 = time.perf_counter()
    mesh, gt_sys, ds_track, ds_map, cfg, world_bound = quad_setup()
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder = pretrain_decoder(mesh, cfg["model"], dev, trunc_dist=0.5)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    cfg["model"]["decoder"]["fix"] = True
    log(f"  sequences: {ds_track.num_kfs} frames, tracking and mapping simulated in "
        f"{seq_s:.2f} s; decoder pretrained ({SLAM_PRETRAIN_EPOCHS} epochs) in "
        f"{pretrain_s:.2f} s")
    online, T_est, system, atlas = run_online(
        cfg, ds_track, counters, final_iters=0, ds_map=ds_map,
        R0=np.eye(3, dtype=np.float32), label="the quad run", decoder=decoder)
    T_gt = np.stack([_pose(*ds_track.true_kf_pose_in_world(k)) for k in range(ds_track.num_kfs)])
    T_odom = odometry_trajectory(ds_track)
    ate = trajectory_error(T_est, T_gt, align=True)
    ate_odom = trajectory_error(T_odom, T_gt, align=True)
    sub = [atlas.submap_id_for_kf(k) for k in range(QUAD_FRAMES)]
    in_sub = {name: submap_ate(T, T_gt, sub) for name, T in (("slam", T_est), ("odom", T_odom))}
    online.update(ate_prefusion=ate, ate_odometry_only=ate_odom, ate_in_submaps=in_sub)
    c = online["launches"]
    log(f"  online: {online['frames']} frames in {online['submaps']} submaps (capacity "
        f"{online['capacity']}), run {online['run_s']:.2f} s; launches {c}")
    _log_frames(online, card)
    log(f"  pre-fusion ATE RMSE {100 * ate['ate_rmse']:.3f} cm, rotation RMSE "
        f"{ate['rot_rmse_deg']:.4f} deg; odometry alone: ATE RMSE "
        f"{100 * ate_odom['ate_rmse']:.3f} cm, rotation RMSE {ate_odom['rot_rmse_deg']:.4f} deg")
    log(f"  within the submaps (each aligned on its own): ATE RMSE "
        f"{100 * in_sub['slam']['ate_rmse']:.3f} cm (per submap "
        f"{', '.join(f'{100 * v:.3f}' for v in in_sub['slam']['per_submap'])}); odometry alone "
        f"{100 * in_sub['odom']['ate_rmse']:.3f} cm "
        f"({', '.join(f'{100 * v:.3f}' for v in in_sub['odom']['per_submap'])})")
    expected_submaps = -(-QUAD_FRAMES // QUAD_SUBMAP_SIZE)
    check(online["submaps"] == expected_submaps and online["frames"] == QUAD_FRAMES,
          f"{online['submaps']} submaps and {online['frames']} keyframes, expected "
          f"{expected_submaps} and {QUAD_FRAMES}")
    # Tracking must beat the odometry inside the submaps; across them the
    # trajectory carries the anchors' drift, which fusion corrects.
    check(in_sub["slam"]["ate_rmse"] < in_sub["odom"]["ate_rmse"],
          f"ATE within the submaps {in_sub['slam']['ate_rmse']:.4f} m not below the "
          f"odometry's {in_sub['odom']['ate_rmse']:.4f} m")
    check(ate["ate_rmse"] < QUAD_MAX_ATE_M,
          f"pre-fusion ATE {ate['ate_rmse']:.4f} m not below {QUAD_MAX_ATE_M:.4f} m (the "
          f"JAX package's CPU run {JAX_QUAD_ATE_M:.4f} m + 5 cm)")
    # Every Mapper drew from the one device pool of the mapping sequence, and
    # nothing of the first submap's tracker and mapper stayed on the card:
    # the steps after the spawn hold what the steps before it held.
    mem = online["memory_after_step"]
    spawn_step = QUAD_SUBMAP_SIZE - 1          # step k adds keyframe k + 1
    before, after = mem[max(spawn_step - 2, 0)], mem[min(spawn_step + 2, len(mem) - 1)]
    online["memory_before_after_spawn"] = [before, after]
    log(f"  card memory allocated two frames before the spawn {before / 2 ** 20:.1f} MiB, "
        f"two after {after / 2 ** 20:.1f} MiB; device pools of the mapping sequence "
        f"{online['device_pools']}")
    check(online["device_pools"] == 1, f"{online['device_pools']} device pools were built")
    check(after <= before + 2 ** 20, f"the card holds {(after - before) / 2 ** 20:.1f} MiB more "
          "after the spawn than before it")
    # Per LM iteration 2 interp forwards, 2 points-only backwards and 1
    # decode; per mapping step (features only: no stability in this config)
    # 2 interp forwards, 2 table-gradient backwards, 1 decode.
    m = cfg["mapping"]
    tracked = QUAD_FRAMES - expected_submaps
    lm_iters = tracked * cfg["tracking"]["lm_max_iter"]
    map_steps = expected_submaps * m["init_iterations"] + tracked * m["iters_per_frame"]
    want = dict(interp=2 * lm_iters + 2 * map_steps, interp_points_grad=2 * lm_iters,
                interp_grad=2 * map_steps, decode=lm_iters + map_steps, fused=0,
                interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(c[name] == n, f"quad run: {name} launched {c[name]} times, expected {n} "
              f"({lm_iters} LM iterations, {map_steps} mapping steps)")
    online.update(lm_iterations=lm_iters, map_steps=map_steps)
    online["fusion"] = fuse_quad(atlas, ds_map, ds_track, cfg, counters, T_gt, ate, card)

    mesh_bound = (np.asarray(world_bound, np.float32)
                  + np.array([-0.5, 0.5], np.float32))        # the demo's _mesh_bound
    fused, cons = consolidate_and_compare(atlas, mesh_bound, counters)
    log(f"  consolidated grid {cons['fused_shapes']} in {cons['seconds']:.2f} s ({card}; "
        f"{cons['chunks']} chunks; launches {cons['launches']}); node features against the "
        f"atlas query: max |diff| {cons['node_max_abs_err']:.3e}; fused-vs-atlas |dSDF| at "
        f"{QUAD_COMPARE_POINTS} points: mean {cons['sdf_error']['mean_abs']:.3e}, p99 "
        f"{cons['sdf_error']['p99_abs']:.3e}, max {cons['sdf_error']['max_abs']:.3e}")
    mesh_pred, lattice = fused_mesh(fused, mesh_bound, counters)
    t0 = time.perf_counter()
    recon = mesh_reconstruction_metrics(mesh_pred, gt_sys, n_points=100000,
                                        threshold=QUAD_FSCORE_THRESH)
    lattice["metrics_s"] = time.perf_counter() - t0
    # Where the fused mesh's surface lies: its vertices' signed distance to
    # the GT, and the field where no grid reaches (zero features).
    sd = gt_sys.signed_distance(np.asarray(mesh_pred.vertices, np.float32))
    with torch.no_grad():
        far = float(fused(torch.full((1, 3), 1e4, device=dev)))
    lattice.update(vertex_sdf_median_m=float(np.median(sd)),
                   vertices_within_thresh=float(np.mean(np.abs(sd) < QUAD_FSCORE_THRESH)),
                   field_at_zero_features_m=far)
    log(f"  fused mesh {QUAD_MESH_RESOLUTION}^3: {lattice['seconds']:.2f} s (lattice and marching "
        f"cubes; {card}), {lattice['vertices']} vertices; at {QUAD_FSCORE_THRESH} m: F-score "
        f"{recon['F-score (%)']:.3f} % (the JAX package's CPU run {JAX_QUAD_FSCORE:.3f} %), "
        f"Chamfer_L1 {recon['Chamfer_L1 (cm)']:.3f} cm ({JAX_QUAD_CHAMFER_CM:.3f}); "
        f"launches {lattice['launches']}")
    log(f"  the fused mesh's vertices: median signed distance to the GT "
        f"{lattice['vertex_sdf_median_m']:.3f} m, {100 * lattice['vertices_within_thresh']:.1f} % "
        f"within {QUAD_FSCORE_THRESH} m; the field at zero features (no grid) "
        f"{lattice['field_at_zero_features_m']:.4f} m")
    check(recon["Chamfer_L1 (cm)"] < QUAD_MAX_CHAMFER_CM,
          f"fused mesh Chamfer_L1 {recon['Chamfer_L1 (cm)']:.3f} cm not below "
          f"{QUAD_MAX_CHAMFER_CM:.3f} cm (the JAX package's CPU run + 25 %)")
    online.update(consolidation=cons, mesh=lattice, reconstruction=recon,
                  sequences_s=seq_s, pretrain_s=pretrain_s,
                  mesh_bf16=bf16_fused_mesh(fused, mesh_bound, gt_sys, recon, counters, card))
    return online


# Phase 10 (d): phase 6's fused grid meshed from bf16 storage, as
# demo/full_slam_newer_college.py:631 meshes it: its F-score within 0.5
# points of the float32 mesh's, its lattice within 0.02 of the float32
# field's scale, and the demo's 512^3 field timed in both dtypes.
QUAD_BF16_FSCORE_MARGIN = 0.5
QUAD_BF16_FIELD_OF_SCALE = 0.02
QUAD_FIELD_RESOLUTION = 512


def bf16_fused_mesh(fused, mesh_bound, gt_sys, recon32, counters, card):
    """The fused grid's mesh and lattice from bf16 storage against float32's,
    and the 512^3 field's seconds in turns (float32, bf16, bf16, float32)."""
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import cast_feature_storage, extract_fields
    mesh16, lattice = fused_mesh(fused, mesh_bound, counters, feature_dtype="bfloat16")
    recon16 = mesh_reconstruction_metrics(mesh16, gt_sys, n_points=100000,
                                          threshold=QUAD_FSCORE_THRESH)
    fused16 = cast_feature_storage(fused)
    u32 = extract_fields(fused, mesh_bound, QUAD_MESH_RESOLUTION)
    u16 = extract_fields(fused16, mesh_bound, QUAD_MESH_RESOLUTION)
    scale = float(np.abs(u32).max())
    field_err = float(np.abs(u16 - u32).max())
    secs = {"f32": [], "bf16": []}
    for label in ("f32", "bf16", "bf16", "f32"):
        q = fused if label == "f32" else fused16
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_fields(q, mesh_bound, QUAD_FIELD_RESOLUTION)
        secs[label].append(time.perf_counter() - t0)
    f32_s, bf16_s = min(secs["f32"]), min(secs["bf16"])
    out = dict(lattice, reconstruction=recon16, field_max_abs_diff=field_err, field_scale=scale,
               field_512_s_f32=f32_s, field_512_s_bf16=bf16_s, field_512_runs=secs,
               table_bytes_f32=sum(f.numel() * 4 for f in fused.features),
               table_bytes_bf16=sum(f.numel() * 2 for f in fused16.features))
    log(f"  (d) fused mesh {QUAD_MESH_RESOLUTION}^3 from bf16 storage: F-score "
        f"{recon16['F-score (%)']:.3f} % against float32's {recon32['F-score (%)']:.3f} %, "
        f"Chamfer_L1 {recon16['Chamfer_L1 (cm)']:.3f} cm ({recon32['Chamfer_L1 (cm)']:.3f}); "
        f"lattice max |bf16 - float32| {field_err:.4e} of scale {scale:.4f}; launches "
        f"{lattice['launches']}; {QUAD_FIELD_RESOLUTION}^3 field {f32_s:.3f} s float32, "
        f"{bf16_s:.3f} s bf16 ({card}; tables {out['table_bytes_f32']} B, "
        f"{out['table_bytes_bf16']} B)")
    check(abs(recon16["F-score (%)"] - recon32["F-score (%)"]) < QUAD_BF16_FSCORE_MARGIN,
          f"bf16 fused mesh F-score {recon16['F-score (%)']:.3f} % not within "
          f"{QUAD_BF16_FSCORE_MARGIN} points of float32's {recon32['F-score (%)']:.3f} %")
    check(field_err <= QUAD_BF16_FIELD_OF_SCALE * scale,
          f"bf16 fused lattice off float32's by {field_err:.4e}, scale {scale:.4f}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: submap alignment (demo/align_submaps.py --method miso --use_sdf).
# ---------------------------------------------------------------------------

ALIGN_EPOCHS = 250
ALIGN_ITERS = 150
ALIGN_LR = 5e-3
ALIGN_NOISE_DEG = 3.0
ALIGN_NOISE_M = 0.15
# The JAX package's CPU run of the same demo (JAX_PLATFORMS=cpu python
# demo/align_submaps.py --use_sdf): 3.000 deg / 15.0 cm before, after the
# alignment these, in 30.8 s.  The port's run is held within 0.3 deg and
# 1.5 cm of them, and under a third of the perturbation.
JAX_ALIGN_ROT_DEG = 0.36045199632644653
JAX_ALIGN_TRANS_M = 0.012236502021551132
ALIGN_ROT_MARGIN_DEG = 0.3
ALIGN_TRANS_MARGIN_M = 0.015


def build_align_atlas(device, epochs=ALIGN_EPOCHS):
    """demo/align_submaps.py::build_synthetic_atlas through the port:
    room_scene(6.0) with a box and an icosphere in the middle, an 8 -> 32 ->
    1 decoder pretrained with a grid on the whole scene and fixed, then 2
    submaps (local bound 6 x 6 x 3.6 m, 0.75 m / 0.15 m cells, F = 4) centred
    at x = -1.5 and +1.5, each trained on the scene's samples in its own
    frame with tsdf_loss_3d.  Returns (atlas, submap centres, observations):
    ``observations(s, rng, n=8192)`` gives the first n of a scene batch's
    samples inside submap s's bound, in its frame (coords, sdf, valid), as
    the demo's SyntheticSubmapObs hands them to the vfpp and mips
    baselines."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import box, icosphere, merge_meshes, room_scene
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.trainer import GridTrainer
    verts, tris = merge_meshes(room_scene(6.0, seed=0),
                               box(size=(0.9, 0.7, 1.1), center=(0.0, 0.8, -0.4)),
                               icosphere(2, 0.45, center=(0.2, -1.0, 0.0)))
    mesh = TriangleMesh(verts, tris)
    centers = [np.array([-1.5 + 3.0 * s, 0, 0], np.float32) for s in range(2)]
    bound_local = np.array([[-3.0, 3.0], [-3.0, 3.0], [-1.8, 1.8]], np.float32)
    cfg_model = {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
                 "bound": bound_local.tolist(), "base_cell_size": 0.75,
                 "per_level_scale": 5.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                    "pos_invariant": True, "fix": False, "pretrained_model": None},
        "pose": {"optimize": True, "num_poses": 1}}
    train_cfg = {"optimizer": "adam", "learning_rate": 5e-3, "epochs": epochs,
                 "max_epochs_in_level": 80, "grid_training_mode": "coordinate+joint"}
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=0.3)
    ds_all = Sdf3D(mesh, batch_size=2 ** 13, total_samples=2 ** 16, trunc_dist=0.3)
    pre = create_grid_net(dict(cfg_model, grid=dict(cfg_model["grid"],
                                                    bound=ds_all.bound.tolist())),
                          generator=torch.Generator().manual_seed(11), device=device)
    GridTrainer(train_cfg, pre, loss_fn, ds_all).train()
    cfg_model["decoder"]["fix"] = True
    atlas = GridAtlas(cfg_model, max_kfs_per_submap=1, device=device)
    for c in centers:
        atlas.add_submap(bound_local, np.eye(3, dtype=np.float32), c)
        atlas.add_kf()
    atlas.set_decoder(tuple((W.detach(), b.detach()) for W, b in pre.decoder_params),
                      fixed=True)

    class LocalSdf:
        def __init__(self, center):
            self.center = center

        def sample(self, rng):
            b = ds_all.sample(rng)
            c = b["coords"] - self.center
            inside = np.all((c >= bound_local[:, 0]) & (c <= bound_local[:, 1]), axis=1,
                            keepdims=True)
            return {"coords": c.astype(np.float32), "sdf": b["sdf"],
                    "sdf_valid": b["sdf_valid"] * inside, "sdf_sign": b["sdf_sign"] * inside,
                    "sdf_signs": b["sdf_signs"] * inside}

    for s, c in enumerate(centers):
        atlas.set_submap(s, GridTrainer(train_cfg, atlas.get_submap(s), loss_fn,
                                        LocalSdf(c)).train())

    def observations(s, rng, n=8192):
        b = ds_all.sample(rng)
        c = (b["coords"] - centers[s]).astype(np.float32)
        sel = np.flatnonzero(np.all((c >= bound_local[:, 0]) & (c <= bound_local[:, 1]),
                                    axis=1))[:n]
        return c[sel], b["sdf"][sel], b["sdf_valid"][sel]

    return atlas, centers, observations


def submap_pose_errors(atlas, centers):
    """Rotation RMSE (degrees) and translation RMSE (m) of submaps 1.. against
    their true poses (identity, at their centres)."""
    from miso_tpu_torch.ops import se3
    R, t = atlas.params.updated_submap_poses()
    S = atlas.num_submaps
    rot = float(se3.rotation_rmse_deg(R[1:S], torch.eye(3, device=R.device).expand(S - 1, 3, 3)))
    gt = torch.as_tensor(np.stack(centers[1:]), device=t.device)
    return rot, float(torch.sqrt(((t[1:S] - gt) ** 2).sum(-1).mean()))


def perturb_submaps(atlas):
    """demo/align_submaps.py's perturbation: every submap but 0 moved by
    ALIGN_NOISE_DEG about a random axis and ALIGN_NOISE_M along a random
    direction, drawn from numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    for s in range(1, atlas.num_submaps):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        dr = axis * np.radians(ALIGN_NOISE_DEG)
        dt = rng.standard_normal(3)
        dt = dt / np.linalg.norm(dt) * ALIGN_NOISE_M
        atlas.set_submap_pose_correction(s, dr.astype(np.float32), dt.astype(np.float32))


def phase_align(card):
    """demo/align_submaps.py --method miso --use_sdf through the port: the
    synthetic atlas (build_align_atlas), submap 1 moved by 3 degrees and
    15 cm (perturb_submaps), then align_multiple_submaps_hierarchical with
    latent levels [0, 1] and the SDF finetune, 150 iterations each, lr 5e-3,
    L2, every vertex over the norm threshold.  Gates: both errors under a
    third of the perturbation and within ALIGN_*_MARGIN of the JAX package's
    CPU run.  Launches exact: per iteration one slot-id forward and one
    points-only backward a level, plus a decode per SDF iteration; the source
    terms and alignment coordinates once.  Then the baselines and InfoNCE
    (align_baselines) from a copy of the atlas taken before the
    perturbation."""
    from miso_tpu_torch.align.miso import align_multiple_submaps_hierarchical
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_per_point_cuda,
                                                 grid_interpolate_per_point_plain)
    dev = torch.device("cuda")
    counters = kernel_counters()
    t0 = time.perf_counter()
    atlas, centers, observations = build_align_atlas(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    trained = atlas.copy_to(dev)
    perturb_submaps(atlas)
    rot0, tr0 = submap_pose_errors(atlas, centers)
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    info = align_multiple_submaps_hierarchical(
        atlas, level_iters=ALIGN_ITERS, finetune_iters=ALIGN_ITERS, lr=ALIGN_LR,
        align_loss="L2", latent_levels=[0, 1], skip_finetune=False, seed=0)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    c = _read_counts(counters)
    rot1, tr1 = submap_pose_errors(atlas, centers)
    L, S = atlas.num_levels, atlas.num_submaps
    steps = ALIGN_ITERS + 1
    # Per step L forwards and L points-only backwards (every level is queried
    # and sliced), a decode per SDF step; the source terms once a stage (L
    # forwards, and a decode for the SDF's); the exact alignment coordinates
    # query each submap's levels at each level's vertices (L single-grid
    # forwards a submap and level).
    want = dict(interp_slot=L * 3 * steps + 3 * L, interp_slot_points_grad=L * 3 * steps,
                decode=steps + 1, interp=L * L * S, interp_grad=0, interp_points_grad=0,
                interp_slot_grad=0, fused=0, interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(c[name] == n, f"alignment: {name} launched {c[name]} times, expected {n}")
    # The slot-id kernels at this path's shapes: the trained fine level at the
    # alignment coordinates of both submaps.
    errs = {}
    p = atlas.params
    C, _ = atlas.alignment_coords_stacked(L - 1)
    ids = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(C.shape[1])
    pts = C.reshape(-1, 3).contiguous()
    _check_values("align_slot_fwd", grid_interpolate_per_point_cuda(
        p.features[L - 1], ids, pts, p.bounds, p.sizes[L - 1]),
        grid_interpolate_per_point_plain(p.features[L - 1], ids, pts, p.bounds, p.sizes[L - 1]),
        errs)
    report = dict(build_s=build_s, align_s=align_s, launches=c,
                  rot_rmse_deg_before=rot0, trans_rmse_m_before=tr0,
                  rot_rmse_deg_after=rot1, trans_rmse_m_after=tr1,
                  alignment_points=[int(atlas.alignment_coords_stacked(l)[0].shape[1])
                                    for l in range(L)],
                  stages={k: {kk: vv for kk, vv in v.items() if kk != "iteration_results"}
                          for k, v in info.items() if isinstance(v, dict)},
                  precompute_sec=info["precompute_sec"], ctx_build_secs=info["ctx_build_secs"])
    log(f"  atlas built (pretrain and 2 submaps, {ALIGN_EPOCHS} epochs each) in {build_s:.2f} s; "
        f"alignment points a submap {report['alignment_points']}")
    log(f"  miso: before: rotation RMSE {rot0:.4f} deg, translation RMSE {100 * tr0:.3f} cm; "
        f"after {3 * steps} iterations ({align_s:.2f} s, {card}): {rot1:.4f} deg, "
        f"{100 * tr1:.3f} cm (the JAX package's CPU run {JAX_ALIGN_ROT_DEG:.4f} deg, "
        f"{100 * JAX_ALIGN_TRANS_M:.3f} cm); launches {c}")
    check(rot1 < rot0 / 3 and tr1 < tr0 / 3,
          f"alignment left {rot1:.4f} deg / {tr1:.4f} m of {rot0:.4f} deg / {tr0:.4f} m")
    check(abs(rot1 - JAX_ALIGN_ROT_DEG) < ALIGN_ROT_MARGIN_DEG
          and abs(tr1 - JAX_ALIGN_TRANS_M) < ALIGN_TRANS_MARGIN_M,
          f"alignment {rot1:.4f} deg / {tr1:.4f} m not within {ALIGN_ROT_MARGIN_DEG} deg / "
          f"{ALIGN_TRANS_MARGIN_M} m of the JAX package's CPU run")
    report["baselines"] = align_baselines(trained, centers, observations, counters, card)
    return report, errs


# Phase 7's baselines and InfoNCE, each from the trained atlas with the same
# perturbation: demo/align_submaps.py --method vfpp / mips (8192 observations
# a submap, 4096 a step, 150 iterations at lr 5e-3), --method icp (resolution
# 48, point-to-plane, 100 pose-graph iterations), and the hierarchical
# alignment with InfoNCE (latent levels 0 and 1, no SDF finetune, 4096 points
# a pair a step, 150 iterations a level).  The JAX package's CPU run of the
# same (JAX_PLATFORMS=cpu python3 scripts/jax_align_baselines.py, 76 s on 8 CPU
# cores, the atlas built once in 23 s): rotation (deg) and translation (m)
# RMSE of submap 1 after, from 3.000 deg / 15.0 cm.
BASELINE_OBS = 8192
BASELINE_SUBSAMPLE = 4096
JAX_ALIGN_AFTER = {"vfpp": (0.02797645516693592, 0.0020677954889833927),
                   "mips": (0.09691329300403595, 0.002780057955533266),
                   "icp": (0.45283961296081543, 0.04225658252835274),
                   "infonce": (0.1312212347984314, 0.0023999169934540987)}
# (rotation deg, translation m) margins to the JAX run; vfpp and mips must also
# end under a third of the perturbation, the ICP under the perturbation.
# InfoNCE's rotation margin is set from the card's spread: ten runs on an
# NVIDIA H100 80GB HBM3 at 700 W (nine of scripts/align_spread.py, one of
# this script) read 0.304-0.406 deg, mean 0.345, standard deviation 0.038,
# against the JAX run's 0.131 (each package trains its own atlas from its own
# draws, and InfoNCE follows the features more than the other losses do);
# 0.3 deg put the limit 2.3 deviations above the mean, 0.36 puts it 3.8.  Every other limit sits more than 10 deviations
# from its runs' mean.
BASELINE_MARGINS = {"vfpp": (0.3, 0.015), "mips": (0.3, 0.015), "icp": (0.3, 0.02),
                    "infonce": (0.36, 0.015)}
FIRST_STEP_RTOL = 1e-4
FIRST_STEP_GRAD_OF_MAX = 1e-4


def baseline_pair_loss(method, atlas):
    """The pair loss that generic_align_multiple_submaps takes, as
    demo/align_submaps.py builds it for vfpp and mips."""
    from miso_tpu_torch.align.baselines import pairwise_loss_mips, pairwise_loss_vfpp
    fn = pairwise_loss_vfpp if method == "vfpp" else pairwise_loss_mips
    kw = {"trunc_dist": 0.3} if method == "vfpp" else {"surf_tol": 0.02}

    def pair_loss(params, s, d, key, ctx):
        return fn(params, atlas, s, d, *ctx[s], key=key, subsample_points=BASELINE_SUBSAMPLE,
                  **kw)
    return pair_loss


def _loss_and_pose_grads(loss, atlas):
    """(value, d rot, d trans) of a loss dict over atlas's pose corrections."""
    p = atlas.params
    rot = p.sub_rot_corr.detach().clone().requires_grad_()
    trans = p.sub_trans_corr.detach().clone().requires_grad_()
    total = sum(loss(p.replace(sub_rot_corr=rot, sub_trans_corr=trans)).values())
    d_rot, d_trans = torch.autograd.grad(total, (rot, trans))
    return float(total), d_rot.cpu(), d_trans.cpu()


def first_step_check(method, atlas, obs):
    """The first step's loss and pose gradient on the card against the same
    call on a CPU copy of the atlas (the plain versions), with the same
    draws (CPU generators).  Returns the errors."""
    from miso_tpu_torch.align.miso import PairGenerators, make_vmapped_pair_loss, pair_context
    cpu = atlas.copy_to("cpu")
    out = {}
    for name, a in (("cuda", atlas), ("cpu", cpu)):
        if method == "infonce":
            loss_fn = make_vmapped_pair_loss("latent", level=0, align_loss="InfoNCE",
                                             subsample_points=BASELINE_SUBSAMPLE)
            ctx = pair_context(a, 0, [(0, 1)], 1)
            out[name] = _loss_and_pose_grads(
                lambda p: loss_fn(p, PairGenerators(0, "cpu"), ctx), a)
        else:
            ctx = {s: tuple(torch.as_tensor(v, device=a.device) for v in o)
                   for s, o in obs.items()}
            fn = baseline_pair_loss(method, a)
            out[name] = _loss_and_pose_grads(
                lambda p: fn(p, 0, 1, torch.Generator().manual_seed(0), ctx), a)
    (v, r, t), (v0, r0, t0) = out["cuda"], out["cpu"]
    scale = max(float(r0.abs().max()), float(t0.abs().max()))
    errs = dict(loss=v, loss_cpu=v0, loss_rel_err=abs(v - v0) / max(abs(v0), 1e-30),
                grad_err_of_max=max(float((r - r0).abs().max()),
                                    float((t - t0).abs().max())) / max(scale, 1e-30))
    check(errs["loss_rel_err"] < FIRST_STEP_RTOL,
          f"{method}: first-step loss {v} on the card against {v0} on the CPU")
    check(errs["grad_err_of_max"] < FIRST_STEP_GRAD_OF_MAX,
          f"{method}: first-step pose gradient differs by {errs['grad_err_of_max']:.2e} of its "
          f"largest entry from the CPU's")
    return errs


def baseline_launches(method, L, S, steps):
    """Exact launches of a baseline run: vfpp's step decodes dst's field at
    the moved points (L interp forwards, a decode) and back-propagates to
    the points (L points-only backwards); mips adds its two stopped SDF
    gradients, each a forward (L interp, a decode) and a points-only backward
    (L); the ICP extracts each submap's 48^3 lattice (one chunk: L forwards
    and a decode a submap) and takes the target normals of its one pair (L
    forwards, a decode, L points-only backwards); InfoNCE computes the
    alignment coordinates (L single-grid forwards a submap and level), then
    per step queries the source and destination features of every level (2L
    slot-id forwards) and back-propagates the destination's (L slot-id
    points-only backwards), over 2 levels."""
    if method == "vfpp":
        want = dict(interp=L * steps, decode=steps, interp_points_grad=L * steps)
    elif method == "mips":
        want = dict(interp=3 * L * steps, decode=3 * steps, interp_points_grad=3 * L * steps)
    elif method == "icp":
        want = dict(interp=(S + 1) * L, decode=S + 1, interp_points_grad=L)
    else:
        want = dict(interp=L * L * S, interp_slot=2 * L * 2 * steps,
                    interp_slot_points_grad=L * 2 * steps, decode=0, interp_points_grad=0)
    return _exact(dict(dict(interp=0, interp_grad=0, interp_points_grad=0, decode=0, fused=0,
                            interp_recompute_backward=0), **want))


def align_baselines(trained, centers, observations, counters, card):
    """Phase 7's runs (b)-(e): vfpp, mips, icp and InfoNCE, each on a copy of
    the trained atlas with perturb_submaps' perturbation."""
    from miso_tpu_torch.align.baselines import align_multiple_submaps_icp
    from miso_tpu_torch.align.miso import (align_multiple_submaps_hierarchical,
                                           generic_align_multiple_submaps)
    dev = trained.device
    rngb = np.random.default_rng(0)
    obs = {s: observations(s, rngb, BASELINE_OBS) for s in range(trained.num_submaps)}
    L, S = trained.num_levels, trained.num_submaps
    reports = {}
    for method in ("vfpp", "mips", "icp", "infonce"):
        atlas = trained.copy_to(dev)
        perturb_submaps(atlas)
        rot0, tr0 = submap_pose_errors(atlas, centers)
        first = None
        if method == "infonce":
            atlas.precompute_coordinates_for_alignment()
        if method != "icp":
            first = first_step_check(method, atlas, obs)
        torch.cuda.synchronize()
        _zero_counts(counters)
        t0 = time.perf_counter()
        info = {}
        if method in ("vfpp", "mips"):
            ctx = {s: tuple(torch.as_tensor(v, device=dev) for v in o) for s, o in obs.items()}
            generic_align_multiple_submaps(atlas, baseline_pair_loss(method, atlas),
                                           num_iters=ALIGN_ITERS, lr=ALIGN_LR, seed=0,
                                           loss_ctx=ctx)
        elif method == "icp":
            info = align_multiple_submaps_icp(atlas)
        else:
            align_multiple_submaps_hierarchical(
                atlas, level_iters=ALIGN_ITERS, lr=ALIGN_LR, align_loss="InfoNCE",
                latent_levels=[0, 1], skip_finetune=True, subsample_points=BASELINE_SUBSAMPLE,
                seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = _read_counts(counters)
        rot1, tr1 = submap_pose_errors(atlas, centers)
        jr, jt = JAX_ALIGN_AFTER[method]
        mr, mt = BASELINE_MARGINS[method]
        reports[method] = dict(rot_rmse_deg_before=rot0, trans_rmse_m_before=tr0,
                               rot_rmse_deg_after=rot1, trans_rmse_m_after=tr1,
                               seconds=seconds, launches=c, first_step=first,
                               beats_perturbation=rot1 < rot0 and tr1 < tr0, **info)
        log(f"  {method}: {rot0:.4f} deg / {100 * tr0:.3f} cm -> {rot1:.4f} deg / "
            f"{100 * tr1:.3f} cm in {seconds:.2f} s ({card}; the JAX package's CPU run "
            f"{jr:.4f} deg / {100 * jt:.3f} cm); first step {first}; launches {c}")
        for name, n in baseline_launches(method, L, S, ALIGN_ITERS + 1).items():
            check(c[name] == n, f"{method}: {name} launched {c[name]} times, expected {n}")
        if method in ("vfpp", "mips"):
            check(rot1 < rot0 / 3 and tr1 < tr0 / 3,
                  f"{method} left {rot1:.4f} deg / {tr1:.4f} m of {rot0:.4f} deg / {tr0:.4f} m")
        if method == "icp":
            check(info["num_edges"] == 1, f"icp registered {info['num_edges']} pairs, not 1")
            check(rot1 < rot0 and tr1 < tr0,
                  f"icp left {rot1:.4f} deg / {tr1:.4f} m of {rot0:.4f} deg / {tr0:.4f} m")
        check(abs(rot1 - jr) < mr and abs(tr1 - jt) < mt,
              f"{method}: {rot1:.4f} deg / {tr1:.4f} m not within {mr} deg / {mt} m of the "
              f"JAX package's CPU run ({jr:.4f} deg / {jt:.4f} m)")
    return reports


# ---------------------------------------------------------------------------
# Phase 8: encoder initialization (demo/encoder_init.py; the in-system recipe
# of tests/test_encoder_system.py; the quad run with --init_mode encode).
# ---------------------------------------------------------------------------

# demo/encoder_init.py's defaults.
ENC_TRUNC = 0.2
ENC_PRETRAIN_EPOCHS = 250
ENC_ENCODER_EPOCHS = 250
ENC_EVAL_EPOCHS = (0, 5, 15, 50)
ENC_FRAMES = 32
ENC_FRAME_BATCH = 2 ** 10
ENC_FRAME_SAMPLES = 2 ** 11
ENC_NOISE = dict(frame_std_rad=0.00872665, frame_std_meter=0.005, distance_std=0.01)
# The JAX package's random draws of the demo (scripts/jax_encoder_init.py
# --decoder_keys 7 --export ENC_DRAWS): the encoders' initial parameters
# (feature_encoder_level_{l}.npz) and draws.npz, with the decoder's initial
# draw and the camera rotations and noisy poses of the training and test
# datasets.  The port runs the demo from them, so the two packages differ
# only in the pred_std noise and in float32 order.
ENC_DRAWS = os.path.join(ROOT, "scripts", "jax_encoder_init_draws")
# The JAX package's CPU run of the demo with its defaults
# (JAX_PLATFORMS=cpu python demo/encoder_init.py --save_dir <dir>, 78 s on 8
# CPU cores): the SDF MAE on the unseen room after K optimize_grid_net epochs
# from the zero and the encoder init; each of the port's readings must lie
# within ENC_MAE_MARGIN of it.  JAX_ENC_DECODER_AT_ZERO: its pretrained
# decoder's value at zero features, which sets the zero init's MAE at K=0.
JAX_ENC_ZERO = {0: 0.12658920884132385, 5: 0.11247103661298752, 15: 0.08540806174278259,
                50: 0.03058832697570324}
JAX_ENC_ENCODE = {0: 0.03696581721305847, 5: 0.036324117332696915, 15: 0.03677443042397499,
                  50: 0.042409174144268036}
JAX_ENC_DECODER_AT_ZERO = 0.13299696147441864
ENC_MAE_MARGIN = 0.30


def enc_mae_limit(mode, K):
    """(reference, allowed |difference|) of a phase 8 (a) reading."""
    ref = (JAX_ENC_ZERO if mode == "zero" else JAX_ENC_ENCODE)[K]
    return ref, ENC_MAE_MARGIN * ref
# tests/test_encoder_system.py's recipe: encoders pretrained 60 steps a level
# on two held-out rooms; zero@30, zero@10 and encode@10 init iterations.  It
# runs from the JAX package's draws of the recipe (scripts/
# jax_encoder_system.py --export ENCSYS_DRAWS): its pretrained decoder, the
# encoders' initial parameters, the camera poses.  A decoder the port
# pretrains differs from run to run on the card (float atomics in the
# interp backward), and zero@10's map error follows it: 23.7-46.7 mm over
# five card runs, in-process repeats within 0.7 mm.  JAX_ENCSYS_ERR: the
# JAX package's CPU run of the recipe (the same script), printed beside.
ENCSYS_DRAWS = os.path.join(ROOT, "scripts", "jax_encoder_system_draws")
ENCSYS_FRAMES = 12
ENCSYS_STEPS = 60
ENCSYS_TRUNC = 0.3
ENCSYS_RUNS = (("zero", 30), ("zero", 10), ("encode", 10))
JAX_ENCSYS_ERR = {"zero@30": 0.025633548386394978, "zero@10": 0.04785820655524731,
                  "encode@10": 0.022002428770065308}
# The quad run with --init_mode encode: encoders as the demo's
# pretrain_encoders_synthetic trains them (2 held-out quad scenes, 24-frame
# circuits, 150 epochs a level).  The JAX package's CPU run of the same
# configuration (scripts/jax_quad_prefusion.py --init_mode encode, 994 s on 8
# CPU cores): pre-fusion ATE 11.93 cm (zero init: 29.05 cm), 1.80 cm within
# the submaps.
QUAD_ENC_EPOCHS = 150
JAX_QUAD_ENCODE_ATE_M = 0.1192554883912132


def _set_grid_decoder(grid, decoder):
    """Copy ``decoder`` ((W, b), ...) into a GridNet's and fix it."""
    with torch.no_grad():
        for p, v in zip(grid.decoder, (t for pair in decoder for t in pair)):
            p.copy_(v)
    grid.decoder_fixed = True
    return grid


def _set_grid_poses(grid, R, t):
    with torch.no_grad():
        grid.Rwk.copy_(torch.as_tensor(np.asarray(R), device=grid.Rwk.device))
        grid.twk.copy_(torch.as_tensor(np.asarray(t), device=grid.twk.device))
    return grid


def encoder_init_model_cfg():
    """demo/encoder_init.py's model: 2 levels of F=4, 1.0 m base cells, scale
    4, an 8 -> 32 -> 32 -> 1 decoder, 32 pose rows."""
    return {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0, "bound": None,
                 "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                    "pos_invariant": True, "fix": False, "pretrained_model": None},
        "pose": {"optimize": False, "num_poses": 32},
    }


def pretrain_launches(L, epochs_per_level):
    """Exact launches of pretrain_encoders over L levels: a step of target
    level l runs l + 2 residual passes (L interp forwards and one decode
    each) and one table-only interp backward, at level l."""
    passes = sum((l + 2) * epochs_per_level for l in range(L))
    return dict(interp=L * passes, decode=passes, interp_grad=L * epochs_per_level,
                interp_points_grad=0, fused=0, interp_recompute_backward=0)


def predict_launches(L):
    """One one-shot prediction of L levels: L residual passes."""
    return dict(interp=L * L, decode=L, interp_grad=0, interp_points_grad=0, fused=0,
                interp_recompute_backward=0)


def _check_launches(what, got, want):
    for name, n in _exact(want).items():
        check(got[name] == n, f"{what}: {name} launched {got[name]} times, expected {n}")


def _load_draws(path):
    """The JAX package's draws of a recipe (scripts/jax_encoder_init.py or
    scripts/jax_encoder_system.py --export): (every array of
    ``path/draws.npz``, its decoder ((W, b), ...))."""
    with np.load(os.path.join(path, "draws.npz")) as f:
        draws = dict(f)
    n_layers = sum(k.startswith("W") for k in draws)
    return draws, tuple((draws[f"W{i}"], draws[f"b{i}"]) for i in range(n_layers))


def _posed_from_draws(mesh, draws, name, **kw):
    """A PosedSdf3D built from the JAX package's draws: its camera rotations,
    then its noisy poses.  The true positions come from the numpy stream
    both packages share."""
    from miso_tpu_torch.datasets.sdf_3d import PosedSdf3D
    ds = PosedSdf3D(mesh, rotations=draws[f"{name}_R_gt"], **kw)
    check(np.array_equal(ds.t_world_frame_gt, draws[f"{name}_t_gt"]) and
          np.array_equal(ds.R_world_frame_gt, draws[f"{name}_R_gt"]),
          f"PosedSdf3D {name}: camera poses differ from the JAX package's")
    ds.R_world_frame, ds.t_world_frame = draws[f"{name}_R"], draws[f"{name}_t"]
    return ds


def encoder_init_demo(counters):
    """demo/encoder_init.py through the port, from the JAX package's draws
    (ENC_DRAWS): the decoder pretrained on room_scene(4.0, seed 1), the
    per-level encoders on 3 noisy PosedSdf3D training rooms
    (pretrain_encoders), then on the unseen room_scene(5.0, seed 0) the zero
    and the encoder init, each followed by K optimize_grid_net epochs of the
    iSDF loss, and the SDF MAE after each.  Launches exact in every stage.
    Returns the report."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.models.encoder import Encoder, EncoderObservation
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.ops.mlp import mlp_apply
    from miso_tpu_torch.train.local_opt import initialize_grid_net, optimize_grid_net
    from miso_tpu_torch.training.train_encoders import pretrain_encoders
    device = torch.device("cuda")
    td = ENC_TRUNC
    model_cfg = encoder_init_model_cfg()
    draws, decoder_init = _load_draws(ENC_DRAWS)
    posed = dict(frame_batchsize=ENC_FRAME_BATCH, frame_samples=ENC_FRAME_SAMPLES,
                 num_frames=ENC_FRAMES, trunc_dist=td)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    train_meshes = [TriangleMesh(*room_scene(4.0 + i, seed=1 + i)) for i in range(3)]
    v = train_meshes[0].vertices          # Sdf3D's bound: the mesh's box + 0.5 m
    decoder = pretrain_decoder(train_meshes[0], model_cfg, device, epochs=ENC_PRETRAIN_EPOCHS,
                               trunc_dist=td,
                               bound=np.stack([v.min(0) - 0.5, v.max(0) + 0.5], axis=1),
                               decoder_init=decoder_init)
    torch.cuda.synchronize()
    decoder_s = time.perf_counter() - t0
    model_cfg["decoder"]["fix"] = True
    with torch.no_grad():
        decoder_at_zero = float(mlp_apply(decoder, torch.zeros((1, 8), device=device))[0, 0])

    t0 = time.perf_counter()
    datasets, grids = [], []
    for i, mesh in enumerate(train_meshes):
        ds = _posed_from_draws(mesh, draws, f"train{i}", seed=i, **posed, **ENC_NOISE)
        g = create_grid_net(model_cfg, bound=ds.get_inflated_bound(), generator=gen,
                            device=device)
        datasets.append(ds)
        grids.append(_set_grid_poses(_set_grid_decoder(g, decoder), ds.R_world_frame,
                                     ds.t_world_frame))
    encoder = Encoder({"model": model_cfg}, pretrained_dir=ENC_DRAWS, trunc_dist=td,
                      device=device)
    datasets_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    losses = pretrain_encoders(encoder.level_params, grids, datasets, ENC_ENCODER_EPOCHS,
                               trunc_dist=td, pred_std=1e-3, learning_rate=1e-3, seed=0)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    pre_c = _read_counts(counters)
    _check_launches("encoder pretraining", pre_c,
                    pretrain_launches(len(encoder.level_params), ENC_ENCODER_EPOCHS))

    test_mesh = TriangleMesh(*room_scene(5.0, seed=0))
    ds_obs = _posed_from_draws(test_mesh, draws, "test", seed=50, **posed)
    ds_eval = Sdf3D(test_mesh, batch_size=2 ** 14, total_samples=2 ** 16, trunc_dist=td)
    grid = create_grid_net(model_cfg, bound=ds_obs.get_inflated_bound(), generator=gen,
                           device=device)
    _set_grid_poses(_set_grid_decoder(grid, decoder), ds_obs.R_world_frame, ds_obs.t_world_frame)
    b = ds_obs.sample(np.random.default_rng(7))
    with torch.no_grad():
        coords_w = se3.transform_points_by_id(
            torch.as_tensor(b["coords_frame"], device=device),
            torch.as_tensor(b["sample_frame_ids"], device=device).long(),
            torch.as_tensor(ds_obs.R_world_frame, device=device),
            torch.as_tensor(ds_obs.t_world_frame, device=device))
    obs = EncoderObservation(coords_world=coords_w,
                             gt_sdf=torch.as_tensor(b["sdf"], device=device),
                             gt_sdf_sign=torch.as_tensor(b["sdf_signs"], device=device),
                             gt_sdf_valid=torch.as_tensor(b["sdf_valid"], device=device))
    eb = ds_eval.sample(np.random.default_rng(13))
    ex = torch.as_tensor(eb["coords"], device=device)
    ey = eb["sdf"].reshape(-1)
    ev = eb["sdf_valid"].reshape(-1) > 0

    def sdf_mae(g):
        with torch.no_grad():
            pred = g(ex).reshape(-1).cpu().numpy()
        return float(np.abs(pred - ey)[ev].mean())

    cfg_opt = {"loss": {"trunc_distance": td, "trunc_weight": 1.0},
               "train": {"optimizer": "adam", "verbose": False}}
    # A first prediction to build and warm every path, as the demo warms its
    # jit cache, so the timed one is the steady state.
    initialize_grid_net(copy.deepcopy(grid), "encode", encoder, obs)
    encoder.grids.clear()
    results = {}
    for mode in ("zero", "encode"):
        g0 = copy.deepcopy(grid)
        _zero_counts(counters)
        g0, info = initialize_grid_net(g0, mode, encoder if mode == "encode" else None,
                                       obs if mode == "encode" else None)
        init_c = _read_counts(counters)
        encoder.grids.clear()
        _check_launches(f"{mode} init", init_c,
                        predict_launches(g0.num_levels) if mode == "encode"
                        else {k: 0 for k in predict_launches(1)})
        curve, opt_c = {}, {}
        for K in ENC_EVAL_EPOCHS:
            gK = g0
            if K:
                _zero_counts(counters)
                gK, _ = optimize_grid_net(copy.deepcopy(g0), ds_obs, cfg_opt, iterations=K,
                                          learning_rate=1e-3, train_mode="joint",
                                          iterations_per_level=max(K // 3, 1), seed=0)
                opt_c[K] = _read_counts(counters)
                # A step: the interp forward of each level, its backward with
                # the points' gradient (the pose rows are parameters), one
                # decode.
                L = gK.num_levels
                _check_launches(f"optimize_grid_net ({mode}, K={K})", opt_c[K],
                                dict(interp=L * K, interp_grad=L * K, decode=K,
                                     interp_points_grad=0, fused=0,
                                     interp_recompute_backward=0))
            curve[K] = sdf_mae(gK)
        results[mode] = dict(mae_by_epoch=curve, encoder_ms=1e3 * info["total_encoder_time"],
                             init_launches=init_c, optimize_launches=opt_c)
    return dict(results=results, decoder_s=decoder_s, datasets_s=datasets_s,
                pretrain_s=pretrain_s, pretrain_launches=pre_c, decoder_at_zero=decoder_at_zero,
                pretrain_final_loss=[l[-1] for l in losses], observation_points=int(len(ey)),
                encoder_trunc=td)


def encoder_system_setup():
    """tests/test_encoder_system.py's setup through the port, from the JAX
    package's draws of it (ENCSYS_DRAWS): tests/test_slam.py's 12-frame
    orbit of room_scene(4.0) and its model (2 levels of F=4, 1.0 m base
    cells, scale 4, 8 -> 32 -> 32 -> 1), the JAX package's decoder pretrained
    on the scene, encoders pretrained ENCSYS_STEPS steps a level on two
    held-out PosedSdf3D rooms.  Returns (seq, model config, decoder,
    encoder, pretraining seconds)."""
    from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.models.encoder import Encoder
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.training.train_encoders import pretrain_encoders
    mesh = TriangleMesh(*room_scene(4.0, seed=0))
    R, t = orbit_trajectory([0, 0, 0], 1.4, 1.2, ENCSYS_FRAMES, look_at=[0, 0, -0.5])
    seq = SdfSequence(mesh, R, t, frame_samples=2 ** 11, frame_batchsize=2048,
                      trunc_dist=ENCSYS_TRUNC, near_surface_std=0.1, seed=1)
    model_cfg = {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
                 "bound": [[-3.0, 3.0], [-3.0, 3.0], [-2.0, 2.0]],
                 "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                    "pos_invariant": True, "fix": False, "pretrained_model": None},
        "pose": {"optimize": True, "num_poses": 100},
    }
    t0 = time.perf_counter()
    device = torch.device("cuda")
    draws, decoder = _load_draws(ENCSYS_DRAWS)
    decoder = tuple((torch.as_tensor(W, device=device), torch.as_tensor(b, device=device))
                    for W, b in decoder)
    model_cfg["decoder"]["fix"] = True
    gen = torch.Generator().manual_seed(3)
    datasets, grids = [], []
    for i in range(2):
        ds = _posed_from_draws(TriangleMesh(*room_scene(4.0 + 0.5 * i, seed=10 + i)), draws,
                               f"train{i}", frame_batchsize=2 ** 9, frame_samples=2 ** 10,
                               num_frames=16, trunc_dist=ENCSYS_TRUNC, seed=i)
        g = create_grid_net(model_cfg, bound=ds.get_inflated_bound(), num_poses=16,
                            generator=gen, device=device)
        datasets.append(ds)
        grids.append(_set_grid_poses(_set_grid_decoder(g, decoder), ds.R_world_frame,
                                     ds.t_world_frame))
    encoder = Encoder({"model": model_cfg}, pretrained_dir=ENCSYS_DRAWS,
                      trunc_dist=ENCSYS_TRUNC, device=device)
    pretrain_encoders(encoder.level_params, grids, datasets, ENCSYS_STEPS,
                      trunc_dist=ENCSYS_TRUNC, pred_std=1e-3, learning_rate=1e-3, seed=0)
    torch.cuda.synchronize()
    return seq, model_cfg, decoder, encoder, time.perf_counter() - t0


def encoder_system_run(seq, model_cfg, decoder, init_mode, init_iters, counters, encoder):
    """tests/test_encoder_system.py::_run_system: System over the orbit with
    tests/test_slam.py's CFG (LM tracking), 2 submaps of 6 keyframes,
    ``init_iters`` init-burst iterations (``encoder`` used with
    ``init_mode`` "encode"); the map error is the mean |SDF| of the atlas at
    512 true surface points of keyframes 3 and 9.  Launches exact.  Returns
    the report."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System
    cfg = {
        "tracking": {"solver": "lm", "learning_rate": 1e-3, "loss_type": "GM",
                     "trunc_dist": None, "gm_scale_sdf": 0.1, "lm_lambda": 1e-4,
                     "lm_max_iter": 12, "lm_tol_deg": 0.01, "lm_tol_m": 0.001, "verbose": False},
        "mapping": {"learning_rate": 3e-3, "loss_type": "L1", "weight_sdf": 1.0,
                    "weight_eik": 0.0, "weight_fs": 0.2, "trunc_dist": 0.3,
                    "finite_diff_eps": 0.05, "grad_method": "finitediff",
                    "eik_trunc_dist": 0.3, "verbose": False, "max_replay_frames": 5,
                    "max_replay_freq": 2, "init_iterations": init_iters,
                    "init_iterations_encode": init_iters, "iters_per_frame": 6,
                    "level_iters_per_frame": 2},
        "system": {"init_odom": "external", "submap_size": 6,
                   "submap_local_bound": [[-5.0, 5.0], [-5.0, 5.0], [-5.0, 5.0]],
                   "submap_fov_thresh": 0.0, "save_submap_mesh": False,
                   "submap_init_mode": init_mode},
        "visualizer": {"enable": False},
        "train": {"grid_training_mode": "coordinate+joint", "relchange_tol": 0.0},
    }
    device = torch.device("cuda")
    atlas = GridAtlas(model_cfg, max_kfs_per_submap=6, device=device)
    atlas.set_decoder(decoder, fixed=True)
    R0, t0 = seq.true_kf_pose_in_world(0)
    torch.cuda.synchronize()
    _zero_counts(counters)
    t_start = time.perf_counter()
    system = System(atlas, seq, seq, cfg, R0, t0, verbose=False,
                    encoder=encoder if init_mode == "encode" else None)
    system.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_start
    c = _read_counts(counters)
    check(atlas.num_keyframes == seq.num_kfs and atlas.num_submaps == 2,
          f"{atlas.num_keyframes} keyframes in {atlas.num_submaps} submaps")
    L, S = atlas.num_levels, atlas.num_submaps
    if init_mode == "encode":
        check(len(system.encoder_info) == S, f"{len(system.encoder_info)} encoder inits")
        check(len(encoder.grids) == 0, f"{len(encoder.grids)} grids left registered")
    lm_iters = (seq.num_kfs - S) * cfg["tracking"]["lm_max_iter"]
    map_steps = S * init_iters + (seq.num_kfs - S) * 6
    enc = S if init_mode == "encode" else 0
    _check_launches(f"System {init_mode}@{init_iters}", c, dict(
        interp=2 * lm_iters + 2 * map_steps + enc * L * L,
        interp_points_grad=2 * lm_iters, interp_grad=2 * map_steps,
        decode=lm_iters + map_steps + enc * L, fused=0, interp_recompute_backward=0))
    errs = []
    with torch.no_grad():
        for kf in (3, 9):
            pts = seq.sampled_points_at_kf(kf)[:512]
            R, t = seq.true_kf_pose_in_world(kf)
            world = torch.as_tensor((pts @ np.asarray(R).T + np.asarray(t)).astype(np.float32),
                                    device=device)
            errs.append(float(atlas.params(world).abs().mean()))
    return dict(init_mode=init_mode, init_iters=init_iters, err=float(np.mean(errs)),
                run_s=run_s, launches=c,
                encoder_ms=[1e3 * i["encoder_time"] for i in system.encoder_info])


def encoder_system_runs(seq, model_cfg, decoder, counters, encoder):
    """ENCSYS_RUNS through encoder_system_run.  Returns (the reports, the map
    errors), each by "mode@iters"."""
    runs = {f"{mode}@{iters}": encoder_system_run(seq, model_cfg, decoder, mode, iters,
                                                  counters, encoder)
            for mode, iters in ENCSYS_RUNS}
    return runs, {k: r["err"] for k, r in runs.items()}


def quad_encoders(decoder, cfg_model):
    """demo/full_slam_newer_college.py::pretrain_encoders_synthetic for the
    quad scene: two held-out courtyards (seeds 1, 2), 24-frame LiDAR
    circuits simulated as the demo's mapping sequences (0.15 m voxels), one
    shared bound, the run's decoder, QUAD_ENC_EPOCHS steps a level.  Returns
    the Encoder and its pretraining seconds."""
    from miso_tpu_torch.datasets.sequence import SdfSequence, circuit_trajectory
    from miso_tpu_torch.datasets.shapes import quad_scene
    from miso_tpu_torch.models.encoder import Encoder
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.training.train_encoders import pretrain_encoders
    device = torch.device("cuda")
    t0 = time.perf_counter()
    scenes = []
    for i in range(2):
        verts, tris = quad_scene(40.0, seed=1 + i, path_half_extent=14.0)
        R, t = circuit_trajectory(14.0, 1.5, 24, laps=1.0, wobble=0.3)
        scenes.append((verts, tris, R, t))
    bound = np.stack([np.min([v.min(0) for v, *_ in scenes], 0) - 1.0,
                      np.max([v.max(0) for v, *_ in scenes], 0) + 1.0], axis=1)
    gen = torch.Generator().manual_seed(0)
    datasets, grids = [], []
    for i, (verts, tris, R, t) in enumerate(scenes):
        ds = SdfSequence(TriangleMesh(verts, tris), R, t, frame_samples=2 ** 11,
                         frame_batchsize=512, trunc_dist=0.5, near_surface_n=2,
                         near_surface_std=0.25, free_space_n=1, behind_surface_n=1, seed=i,
                         scan_pattern="lidar", width=192, height=64, voxel_size=0.15)
        c2 = copy.deepcopy(cfg_model)
        c2["pose"] = {"optimize": False, "num_poses": len(R)}
        g = create_grid_net(c2, bound=bound, generator=gen, device=device)
        datasets.append(ds)
        grids.append(_set_grid_poses(_set_grid_decoder(g, decoder), ds.R_gt, ds.t_gt))
    encoder = Encoder({"model": cfg_model}, generator=gen, trunc_dist=0.5, device=device)
    pretrain_encoders(encoder.level_params, grids, datasets, QUAD_ENC_EPOCHS, trunc_dist=0.5,
                      pred_std=1e-3, learning_rate=1e-3, seed=0)
    torch.cuda.synchronize()
    return encoder, time.perf_counter() - t0


def phase_quad_encode(card, ate_zero):
    """Phase 6's quad run with --init_mode encode: the same configuration and
    a decoder pretrained as phase 6's, encoders from quad_encoders, every
    submap's features from the encoder's one-shot prediction on its anchor
    keyframe and a 33-iteration init burst (init_iterations // 3); the
    Fuser is not run.  Gate: the pre-fusion ATE within QUAD_ATE_MARGIN_M of
    the JAX package's CPU run of the same configuration.  Launches exact."""
    from miso_tpu_torch.utils.eval import trajectory_error
    dev = torch.device("cuda")
    counters = kernel_counters()
    mesh, _, ds_track, ds_map, cfg, _ = quad_setup()
    decoder = pretrain_decoder(mesh, cfg["model"], dev, trunc_dist=0.5)
    cfg["model"]["decoder"]["fix"] = True
    encoder, enc_pretrain_s = quad_encoders(decoder, cfg["model"])
    cfg["system"]["submap_init_mode"] = "encode"
    online, T_est, system, atlas = run_online(
        cfg, ds_track, counters, final_iters=0, ds_map=ds_map,
        R0=np.eye(3, dtype=np.float32), label="the quad run with encoder init",
        decoder=decoder, encoder=encoder)
    T_gt = np.stack([_pose(*ds_track.true_kf_pose_in_world(k)) for k in range(ds_track.num_kfs)])
    ate = trajectory_error(T_est, T_gt, align=True)
    S, L = atlas.num_submaps, atlas.num_levels
    m = cfg["mapping"]
    init_enc = max(m["init_iterations"] // 3, 1)
    tracked = QUAD_FRAMES - S
    lm_iters = tracked * cfg["tracking"]["lm_max_iter"]
    map_steps = S * init_enc + tracked * m["iters_per_frame"]
    c = online["launches"]
    _check_launches("quad run with encoder init", c, dict(
        interp=2 * lm_iters + 2 * map_steps + S * L * L, interp_points_grad=2 * lm_iters,
        interp_grad=2 * map_steps, decode=lm_iters + map_steps + S * L, fused=0,
        interp_recompute_backward=0))
    check(S == -(-QUAD_FRAMES // QUAD_SUBMAP_SIZE), f"{S} submaps")
    check(len(system.encoder_info) == S and len(encoder.grids) == 0,
          f"{len(system.encoder_info)} encoder inits, {len(encoder.grids)} grids registered")
    enc_ms = [1e3 * i["encoder_time"] for i in system.encoder_info]
    spawn_parts = system.spawn_ms
    online.update(ate_prefusion=ate, ate_zero_init=ate_zero, encoder_ms=enc_ms,
                  encoder_pretrain_s=enc_pretrain_s, init_iterations_encode=init_enc,
                  map_steps=map_steps, lm_iterations=lm_iters,
                  encode_beats_zero=bool(ate["ate_rmse"] < ate_zero["ate_rmse"]))
    log(f"  quad run with encoder init: encoders pretrained in {enc_pretrain_s:.2f} s "
        f"({QUAD_ENC_EPOCHS} steps a level); pre-fusion ATE RMSE "
        f"{100 * ate['ate_rmse']:.3f} cm, rotation RMSE {ate['rot_rmse_deg']:.4f} deg (phase 6's "
        f"zero init {100 * ate_zero['ate_rmse']:.3f} cm; the JAX package's CPU run with encoder "
        f"init {100 * JAX_QUAD_ENCODE_ATE_M:.3f} cm); encoder one-shot "
        f"{', '.join(f'{v:.2f}' for v in enc_ms)} ms per submap; spawn parts (ms) "
        f"{spawn_parts} ({card}); launches {c}")
    _log_frames(online, card)
    check(abs(ate["ate_rmse"] - JAX_QUAD_ENCODE_ATE_M) < QUAD_ATE_MARGIN_M,
          f"pre-fusion ATE with encoder init {ate['ate_rmse']:.4f} m not within "
          f"{QUAD_ATE_MARGIN_M} m of the JAX package's CPU run ({JAX_QUAD_ENCODE_ATE_M:.4f} m)")
    return online


def phase_encode(card, quad_ate_zero):
    """(a) demo/encoder_init.py at its defaults, (b) the in-system recipe of
    tests/test_encoder_system.py, (c) the quad run with --init_mode encode."""
    counters = kernel_counters()
    demo = encoder_init_demo(counters)
    z, e = demo["results"]["zero"], demo["results"]["encode"]
    log(f"  (a) demo/encoder_init.py from the JAX package's draws: decoder pretrained in "
        f"{demo['decoder_s']:.2f} s (its value at zero features {demo['decoder_at_zero']:.5f}; "
        f"JAX CPU {JAX_ENC_DECODER_AT_ZERO:.5f}), encoders in {demo['pretrain_s']:.2f} s "
        f"({ENC_ENCODER_EPOCHS} steps a level; {card}); one-shot encoder init "
        f"{e['encoder_ms']:.3f} ms (CUDA-synchronized)")
    for mode, ref in (("zero", JAX_ENC_ZERO), ("encode", JAX_ENC_ENCODE)):
        curve = demo["results"][mode]["mae_by_epoch"]
        log(f"      {mode:6s}: " + "  ".join(
            f"K={k}: MAE {v:.4f} (JAX CPU {ref[k]:.4f})" for k, v in curve.items()))
    log(f"      launches: pretraining {demo['pretrain_launches']}, one-shot "
        f"{e['init_launches']}")
    check(e["mae_by_epoch"][0] < 0.5 * z["mae_by_epoch"][0],
          f"encoder init MAE {e['mae_by_epoch'][0]:.4f} not under half the zero init's "
          f"{z['mae_by_epoch'][0]:.4f}")
    for mode in ("zero", "encode"):
        for k, v in demo["results"][mode]["mae_by_epoch"].items():
            ref, tol = enc_mae_limit(mode, k)
            check(abs(v - ref) <= tol,
                  f"{mode} init, K={k}: MAE {v:.4f} not within {tol:.4f} of the JAX package's "
                  f"CPU run ({ref:.4f})")

    seq, model_cfg, decoder, encoder, setup_s = encoder_system_setup()
    runs, err = encoder_system_runs(seq, model_cfg, decoder, counters, encoder)
    log(f"  (b) in-system recipe from the JAX package's draws (encoders in {setup_s:.2f} s): "
        "map error " + ", ".join(f"{k} {1e3 * v:.3f} mm (JAX CPU {1e3 * JAX_ENCSYS_ERR[k]:.3f})"
                                 for k, v in err.items())
        + f"; encoder one-shot {', '.join(f'{v:.2f}' for v in runs['encode@10']['encoder_ms'])}"
        f" ms; runs {', '.join('%.2f' % r['run_s'] for r in runs.values())} s ({card})")
    check(err["encode@10"] < 1.15 * err["zero@30"],
          f"encode@10 error {err['encode@10']:.5f} not under 1.15 x zero@30's {err['zero@30']:.5f}")
    check(err["encode@10"] < 0.9 * err["zero@10"],
          f"encode@10 error {err['encode@10']:.5f} not under 0.9 x zero@10's {err['zero@10']:.5f}")

    quad = phase_quad_encode(card, quad_ate_zero)
    launches = [demo["pretrain_launches"], e["init_launches"],
                *e["optimize_launches"].values(), *z["optimize_launches"].values(),
                *(r["launches"] for r in runs.values()), quad["launches"]]
    return dict(encoder_init=demo, in_system=dict(runs=runs, err=err, setup_s=setup_s),
                quad=quad, launches=launches)


# ---------------------------------------------------------------------------
# Phase 9: the alternative models (the paper's comparison set) and the 2D grid.
# ---------------------------------------------------------------------------

# Each model at the JAX package's default widths, trained as
# tests/test_models_extra.py trains them (tsdf_loss_3d without the eikonal,
# the base Trainer, Adam at its learning rates), on phase 4's scene and batch.
ALT_EPOCHS = 300
ALT_RESOLUTION = 128
ALT_LOSS = dict(sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0, trunc_dist=0.3)
ALT_LR = {"isdf": 1e-3, "ngp": 5e-3, "pointsdf": 2e-3, "vm": 5e-3}
ALT_MODELS = tuple(ALT_LR)
ALT_REGISTRY = {"isdf": "isdf", "ngp": "ngp", "pointsdf": "pointsdf", "vm": "grid_net"}
ALT_DECODES = {"isdf": 0, "ngp": 1, "pointsdf": 0, "vm": 1}   # decode launches a forward
ALT_TIMED_STEPS = 20
ALT_PROFILE_STEPS = 10
ALT_FIRST_STEP_RTOL = 1e-5
# PointSDF's and the 2D grid's readings follow their random draws (the JAX
# package's PointSDF read F-scores of 91.3-98.2 % over five PRNG keys,
# scripts/jax_alt_models.py --own_draws --keys 0 1 2 3 4; the port's 2D MAE
# 0.018-0.055 m over seeds 0-3 of its own draws), so both packages start
# those two from the same numpy draws (alt_draws), after which they agree to
# 0.05 F-score points and 1e-6 of the MAE over seeds 0-3
# (scripts/alt_models_spread.py); the other three agree to 0.1 points from
# their own draws.  Seed 0 of the shared draws trains the 2D grid worst (MAE
# 0.154 m against 0.018-0.034 for seeds 1-3): every unit of its decoder's
# last hidden layer with a negative output weight dies in training, so the
# output cannot go below the output bias and the negative SDF inside the
# obstacles is lost (alt_2d_readings' inside MAE and prediction minimum).
# Both packages do the same, so the cell keeps seed 0.
ALT_SHARED_DRAWS = ("pointsdf", "grid2d")
# The 2D grid: tests/test_models_extra.py's widths on a 512 x 512 occupancy
# image at 0.05 m a pixel (25.6 m square), Sdf2D's default batch of 2^14.
ALT_2D = dict(size=512, cell=0.05, seed=12, epochs=150, lr=5e-3)
# The JAX package's CPU run of the same configurations
# (JAX_PLATFORMS=cpu python3 scripts/jax_alt_models.py): F-score (%) and
# Chamfer_L1 (cm) of each 128^3 mesh, the 2D grid's MAE over the image and
# mean |SDF| on its boundary pixels (m).
JAX_ALT = {"isdf": (98.61050968700407, 1.5214368062862007),
           "ngp": (97.692723290139, 1.3595594817321084),
           "pointsdf": (96.6086342591395, 1.6726384837298915),
           "vm": (98.43031631979362, 1.329155217581061)}
JAX_ALT_2D_MAE = 0.15360190264547668
JAX_ALT_2D_BOUNDARY = 0.08876407891511917
ALT_FSCORE_MARGIN = 5.0
ALT_CHAMFER_MARGIN = 0.25
ALT_2D_MAE_MARGIN = 0.30


def alt_model_cfg(name, bound):
    """Model config of one alternative model over ``bound`` at the JAX
    package's default widths (VM: phase 4's widths, rank 10)."""
    pose = {"optimize": False, "num_poses": 1}
    if name == "isdf":
        return {"grid": {"bound": bound}, "isdf": {"hidden_size": 256, "hidden_layers_block": 1},
                "pose": pose}
    if name == "ngp":
        return {"grid": {"bound": bound},
                "hash": {"n_levels": 8, "feature_dim": 2, "base_resolution": 16,
                         "per_level_scale": 1.5, "log2_hashmap_size": 19},
                "decoder": {"hidden_dim": 64, "hidden_layers": 1, "out_dim": 1,
                            "pos_invariant": True, "fix": False},
                "pose": pose}
    if name == "pointsdf":
        return {"point": {"total_samples": 50000, "noise_threshold": 0.02,
                          "sample_ratio_surface": 0.4, "sample_ratio_random": 0.2,
                          "feature_dim": 8, "k_neighbors": 8, "resolution": 0.1,
                          "hash_table_size": 2 ** 20, "num_nei_cells": 2, "search_alpha": 1.0,
                          "bound": bound},
                "decoder": {"sinusoidal_pe": True, "hidden_dim": 64, "num_layers": 3,
                            "output_dim": 1},
                "pose": {"num_frames": 1, "optimize": False}}
    cfg = mesh_model_cfg(bound)
    cfg["grid"] = {**cfg["grid"], "type": "VM", "VM": {"rank": 10, "fix_bases": False}}
    return cfg


def alt_image(size=ALT_2D["size"], seed=ALT_2D["seed"]):
    """A (size, size) float32 occupancy image (1 free, 0 occupied) of disks
    and boxes drawn from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    img = np.ones((size, size), np.float32)
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for _ in range(10):
        ci, cj = rng.uniform(0.1 * size, 0.9 * size, 2)
        r = rng.uniform(0.03 * size, 0.1 * size)
        img[(ii - ci) ** 2 + (jj - cj) ** 2 < r ** 2] = 0.0
    for _ in range(8):
        i0, j0 = rng.integers(0, int(0.85 * size), 2)
        h, w = rng.integers(int(0.03 * size), int(0.15 * size), 2)
        img[i0:i0 + h, j0:j0 + w] = 0.0
    return img


ALT_2D_INIT_STD = 1e-4


def alt_2d_cfg(bound):
    return {"spatial_dim": 2,
            "grid": {"type": "regular", "feature_dim": 4, "init_stddev": ALT_2D_INIT_STD,
                     "bound": bound, "base_cell_size": 0.8, "per_level_scale": 4.0,
                     "n_levels": 2},
            "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": True, "fix": False, "pretrained_model": None},
            "pose": {"optimize": False, "num_poses": 1}}


def alt_draws(feature_shapes, feature_std, dims, layernorm, seed=0):
    """Initial trainable parameters drawn with numpy's default_rng(seed) from
    the packages' own distributions: features N(0, feature_std^2) per shape,
    then per decoder layer W ~ U(+-1/sqrt(fan_in)) of shape (in, out) and its
    bias: PointSDF's LayerNorm MLP ((W0, 0), then (g = 1, b = 0, W, 0) a
    layer) when ``layernorm``, else U(+-1/sqrt(fan_in)).  Returns (features,
    layers) in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    feats = [(rng.standard_normal(tuple(sh)) * feature_std).astype(np.float32)
             for sh in feature_shapes]
    layers = []
    for i, (fin, fout) in enumerate(zip(dims[:-1], dims[1:])):
        lim = 1.0 / np.sqrt(fin)
        W = rng.uniform(-lim, lim, (fin, fout)).astype(np.float32)
        if not layernorm:
            layers.append((W, rng.uniform(-lim, lim, (fout,)).astype(np.float32)))
        elif i == 0:
            layers.append((W, np.zeros(fout, np.float32)))
        else:
            layers.append((np.ones(fin, np.float32), np.zeros(fin, np.float32), W,
                           np.zeros(fout, np.float32)))
    return feats, layers


@torch.no_grad()
def set_alt_draws(model, seed=0, std=None):
    """Replace a PointSDF's or a GridNet's features and decoder by
    :func:`alt_draws` of their shapes (features of std ``std``, else
    PointSDF's 0.01 or the 2D grid's); returns the model."""
    pointsdf = isinstance(model.features, torch.nn.Parameter)
    features = [model.features] if pointsdf else list(model.features)
    Ws = [layer[0] if len(layer) == 2 else layer[2] for layer in model.decoder_params]
    dims = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    if std is None:
        std = 0.01 if pointsdf else ALT_2D_INIT_STD
    feats, layers = alt_draws([f.shape for f in features], std, dims, pointsdf, seed)
    for p, a in zip(features, feats):
        p.copy_(torch.as_tensor(a))
    for p, a in zip(model.decoder, [a for layer in layers for a in layer]):
        p.copy_(torch.as_tensor(a))
    return model


def alt_2d_readings(pred, ds):
    """Readings of the predicted SDF at the pixel centres (m): the MAE over
    the image (``mae``), the mean |SDF| on its boundary pixels
    (``boundary_abs_sdf``), the MAE inside the obstacles, where the SDF is
    negative (``inside_mae``), and the prediction's minimum (``pred_min``)."""
    pred = np.asarray(pred, np.float64).reshape(ds.full_sdfs.shape)
    err = np.abs(pred - ds.full_sdfs)
    boundary = np.abs(ds.full_sdfs) <= ds.cell_size
    return dict(mae=float(np.mean(err)), boundary_abs_sdf=float(np.mean(np.abs(pred[boundary]))),
                inside_mae=float(np.mean(err[ds.full_sdfs < 0])), pred_min=float(pred.min()))


def alt_first_step(model, loss_fn, batch):
    """The first training step's loss and gradients on the card against a
    CPU copy of the model on the same batch: the loss and the largest
    gradient entry within ALT_FIRST_STEP_RTOL relative, every gradient entry
    within 1e-4 of the largest; the per-point SDF within 1e-5."""
    from miso_tpu_torch.losses.common import total_loss
    out = {}
    cpu = copy.deepcopy(model).cpu()
    for key, m in (("card", model), ("cpu", cpu)):
        b = {k: torch.as_tensor(v, device=m.bound.device) for k, v in batch.items()}
        tl = total_loss(loss_fn(m, b, None))
        params = [p for p in m.parameters()]
        grads = torch.autograd.grad(tl, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        with torch.no_grad():
            sdf = m(b["coords"])
        out[key] = (float(tl.detach()), [g.detach().cpu() for g in grads], sdf.cpu())
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["card"], out["cpu"]
    big_card = max(float(g.abs().max()) for g in g_card)
    big_cpu = max(float(g.abs().max()) for g in g_cpu)
    rep = dict(loss_card=l_card, loss_cpu=l_cpu,
               loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
               grad_max_card=big_card, grad_max_cpu=big_cpu,
               grad_max_rel=abs(big_card - big_cpu) / big_cpu,
               grad_err_of_max=max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
               / big_cpu,
               sdf_max_abs_err=float((s_card - s_cpu).abs().max()))
    del cpu
    return rep


def alt_train(name, model, loss_fn, ds, lr, epochs, counters):
    """The base Trainer with Adam, each step timed by CUDA events; returns
    the trained model and the run's report (launches exact)."""
    from miso_tpu_torch.train.trainer import Trainer
    trainer = Trainer({"optimizer": "adam", "learning_rate": lr, "epochs": epochs},
                      model, loss_fn, ds)
    step_fn, events, totals = trainer.step_fn, [], []

    def timed_step(*args):
        events.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        events[-1][0].record()
        out = step_fn(*args)
        events[-1][1].record()
        totals.append(out[2])
        return out

    trainer.step_fn = timed_step
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    model = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _read_counts(counters)
    trainer.step_fn = step_fn
    losses = [float(v) for v in totals]
    check(len(losses) == epochs and all(np.isfinite(losses)),
          f"{name}: {len(losses)} finite losses of {epochs} steps")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses[0]} -> {losses[-1]}")
    step_ms = np.array([a.elapsed_time(b) for a, b in events])
    per = ALT_DECODES.get(name, 1)
    check(launches == _exact(dict(interp=0, interp_grad=0, interp_points_grad=0,
                                  decode=per * epochs, fused=0, interp_recompute_backward=0)),
          f"{name}: training launches {launches}, expected {per} decode a step and no other")
    return model, trainer, dict(
        epochs=epochs, train_s=train_s, loss_first=losses[0], loss_last=losses[-1],
        step_ms_median=float(np.median(step_ms)),
        step_ms_median_last20=float(np.median(step_ms[-ALT_TIMED_STEPS:])),
        step_ms_p10=float(np.percentile(step_ms, 10)), launches=launches)


def alt_profile(name, trainer):
    """One training step's wall and device time, idle share and its three
    largest kernels (miso_tpu_torch/utils/profiling.py::breakdown), over
    ALT_PROFILE_STEPS more steps of the trained model."""
    from miso_tpu_torch.utils.profiling import breakdown

    def run(steps):
        for _ in range(steps):
            trainer.train_epoch(0)

    run(2)
    return breakdown(f"{name} training step ({trainer.dataset.batch_size} points)", run,
                     ALT_PROFILE_STEPS, top=8)


def alt_mesh(name, model, scene, counters):
    """save_mesh at ALT_RESOLUTION^3 and its metrics; one decode launch per
    lattice chunk for the models that decode, none else."""
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import save_mesh
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    mesh = save_mesh(model, model.bound, None, resolution=ALT_RESOLUTION)
    mesh_s = time.perf_counter() - t0
    launches = _read_counts(counters)
    chunks = -(-ALT_RESOLUTION ** 3 // MESH_CHUNK)
    check(launches == _exact(dict(interp=0, interp_grad=0, interp_points_grad=0,
                                  decode=ALT_DECODES[name] * chunks, fused=0,
                                  interp_recompute_backward=0)),
          f"{name}: lattice launches {launches} in {chunks} chunks")
    check(len(mesh.triangles) > 0, f"{name}: empty mesh")
    t0 = time.perf_counter()
    metrics = mesh_reconstruction_metrics(mesh, scene, n_points=MESH_METRIC_POINTS)
    return dict(save_mesh_s=mesh_s, metrics_s=time.perf_counter() - t0, chunks=chunks,
                launches=launches, vertices=len(mesh.vertices), metrics=metrics)


def alt_models_3d(scene, ds, counters, card, models=ALT_MODELS, seed=0):
    """(a): each model trained, its first step held to a CPU copy, profiled,
    meshed and scored against the JAX package's CPU run; ``seed`` seeds the
    models' random draws (the config's ``seed``)."""
    from miso_tpu_torch.config import cfg_model
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    bound = ds.bound.tolist()
    loss_fn = make_loss(tsdf_loss_3d, **ALT_LOSS)
    first_batch = ds.sample(np.random.default_rng(0))    # the Trainer's first batch
    reports = {}
    for name in models:
        cfg = {"model": {**alt_model_cfg(name, bound), "name": ALT_REGISTRY[name]}, "seed": seed}
        t0 = time.perf_counter()
        model = cfg_model(cfg, **({"mesh": scene} if name == "pointsdf" else {}))
        if name in ALT_SHARED_DRAWS:
            set_alt_draws(model, seed)
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        first = alt_first_step(model, loss_fn, first_batch)
        model, trainer, train = alt_train(name, model, loss_fn, ds, ALT_LR[name], ALT_EPOCHS,
                                          counters)
        mesh = alt_mesh(name, model, scene, counters)
        prof = alt_profile(name, trainer)
        m = mesh["metrics"]
        ref_f, ref_c = JAX_ALT[name]
        log(f"  {name}: {n_params} parameters, built in {build_s:.2f} s; first step against "
            f"the CPU copy: loss {first['loss_rel']:.2e} rel, largest gradient entry "
            f"{first['grad_max_rel']:.2e} rel, every entry {first['grad_err_of_max']:.2e} of "
            f"it, SDF {first['sdf_max_abs_err']:.2e}; {ALT_EPOCHS} epochs in "
            f"{train['train_s']:.2f} s, step {train['step_ms_median']:.3f} ms median "
            f"({train['step_ms_median_last20']:.3f} the last {ALT_TIMED_STEPS}); loss "
            f"{train['loss_first']:.4f} -> {train['loss_last']:.4f}; mesh {ALT_RESOLUTION}^3 "
            f"in {mesh['save_mesh_s']:.2f} s: F-score {m['F-score (%)']:.2f} % (JAX CPU "
            f"{ref_f}), Chamfer_L1 {m['Chamfer_L1 (cm)']:.3f} cm (JAX CPU {ref_c}); profiled "
            f"step: wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, idle "
            f"{prof['idle_share']:.3f}; top kernels " + "; ".join(
                f"{k['name'][:60]} {k['ms']:.3f} ms ({k['share']:.2f})"
                for k in prof["top_kernels"]) + f" ({card})")
        check(first["loss_rel"] <= ALT_FIRST_STEP_RTOL,
              f"{name}: first loss {first['loss_card']!r} vs the CPU copy's "
              f"{first['loss_cpu']!r}: {first['loss_rel']:.2e} > {ALT_FIRST_STEP_RTOL}")
        check(first["grad_max_rel"] <= ALT_FIRST_STEP_RTOL,
              f"{name}: largest first-step gradient entry {first['grad_max_card']!r} vs "
              f"the CPU copy's {first['grad_max_cpu']!r}")
        check(first["grad_err_of_max"] <= GRAD_RTOL_OF_MAX,
              f"{name}: first-step gradients {first['grad_err_of_max']:.2e} of the largest "
              f"entry from the CPU copy's")
        if name == "pointsdf":
            check(first["sdf_max_abs_err"] <= 1e-5,
                  f"pointsdf: card forward {first['sdf_max_abs_err']:.2e} from the CPU's")
        check(abs(m["F-score (%)"] - ref_f) <= ALT_FSCORE_MARGIN,
              f"{name}: F-score {m['F-score (%)']:.2f} not within {ALT_FSCORE_MARGIN} of the "
              f"JAX CPU run's {ref_f:.2f}")
        check(abs(m["Chamfer_L1 (cm)"] - ref_c) <= ALT_CHAMFER_MARGIN * ref_c,
              f"{name}: Chamfer_L1 {m['Chamfer_L1 (cm)']:.3f} not within "
              f"{100 * ALT_CHAMFER_MARGIN:.0f} % of the JAX CPU run's {ref_c:.3f}")
        reports[name] = dict(parameters=n_params, build_s=build_s, first_step=first,
                             train=train, mesh=mesh, profile=prof)
        del model, trainer
        torch.cuda.empty_cache()
    return reports


def alt_grid_2d(counters, card, seed=0):
    """(b): a 2D GridNet on Sdf2D with the Sdf2D loss entry; the MAE over the
    image against the JAX package's CPU run."""
    from miso_tpu_torch.config import cfg_loss
    from miso_tpu_torch.datasets.sdf_2d import Sdf2D
    from miso_tpu_torch.models.grid_net import create_grid_net
    t0 = time.perf_counter()
    ds = Sdf2D(alt_image(), cell_size=ALT_2D["cell"])
    data_s = time.perf_counter() - t0
    model = set_alt_draws(create_grid_net(alt_2d_cfg(ds.bound.tolist())), seed)
    loss_fn = cfg_loss({"loss": {"name": "Sdf2D"}})
    first = alt_first_step(model, loss_fn, ds.sample(np.random.default_rng(0)))
    model, trainer, train = alt_train("grid2d", model, loss_fn, ds, ALT_2D["lr"],
                                      ALT_2D["epochs"], counters)
    _zero_counts(counters)
    with torch.no_grad():
        pred = model(torch.as_tensor(ds.full_coords.reshape(-1, 2), device="cuda")).cpu()
    launches = _read_counts(counters)
    check(launches == _exact(dict(interp=0, interp_grad=0, interp_points_grad=0, decode=1,
                                  fused=0, interp_recompute_backward=0)),
          f"grid2d: image launches {launches}, expected one decode and no other")
    r = alt_2d_readings(pred.numpy(), ds)
    mae = r["mae"]
    prof = alt_profile("grid2d", trainer)
    log(f"  grid2d: image {ds.sdf.shape} in {data_s:.2f} s, grids "
        f"{[tuple(f.shape) for f in model.features]}; first step: loss {first['loss_rel']:.2e} "
        f"rel, largest gradient entry {first['grad_max_rel']:.2e} rel; {ALT_2D['epochs']} epochs "
        f"in {train['train_s']:.2f} s, step {train['step_ms_median']:.3f} ms median; MAE "
        f"{mae:.4f} m (JAX CPU {JAX_ALT_2D_MAE}), boundary |SDF| {r['boundary_abs_sdf']:.4f} m "
        f"(JAX CPU {JAX_ALT_2D_BOUNDARY}), inside MAE {r['inside_mae']:.4f} m, prediction "
        f"minimum {r['pred_min']:.4f} m; profiled step: device {prof['device_ms']:.3f} ms, idle "
        f"{prof['idle_share']:.3f} ({card})")
    check(first["loss_rel"] <= ALT_FIRST_STEP_RTOL and first["grad_max_rel"] <= ALT_FIRST_STEP_RTOL,
          f"grid2d: first step against the CPU copy {first}")
    check(abs(mae - JAX_ALT_2D_MAE) <= ALT_2D_MAE_MARGIN * JAX_ALT_2D_MAE,
          f"grid2d: MAE {mae:.4f} not within {100 * ALT_2D_MAE_MARGIN:.0f} % of the JAX CPU "
          f"run's {JAX_ALT_2D_MAE:.4f}")
    return dict(data_s=data_s, first_step=first, train=train, image_launches=launches,
                profile=prof, **r)


def phase_alt(card):
    """The alternative models: (a) iSDF, the hash grid, PointSDF and a VM
    GridNet trained on phase 4's scene and meshed, (b) a 2D GridNet on an
    occupancy image.  No interp kernel runs in the phase; the decode kernel
    once per forward of the hash grid, VM and 2D models."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    counters = kernel_counters()
    verts, tris = room_scene(4.0)
    scene = TriangleMesh(verts, tris)
    ds = Sdf3D(scene, batch_size=MESH_BATCH, total_samples=MESH_SAMPLES, trunc_dist=0.3)
    models = alt_models_3d(scene, ds, counters, card)
    grid2d = alt_grid_2d(counters, card)
    launches = [r["train"]["launches"] for r in models.values()] + \
        [r["mesh"]["launches"] for r in models.values()] + \
        [grid2d["train"]["launches"], grid2d["image_launches"]]
    return dict(models=models, grid2d=grid2d, launches=launches)


# ---------------------------------------------------------------------------
# Phase 10: bf16 feature storage (grid.feature_dtype: bfloat16) and the apps.
# ---------------------------------------------------------------------------

# Phase 10 (b): tests/test_train_e2e.py::test_bf16_features's recipe (an
# icosphere, grid.feature_dtype bfloat16, 150 epochs), its MAE on a fresh
# batch under the test's 0.03 and within 30 % of the JAX CPU run's.  Both
# packages start from the same numpy draws (alt_draws of the model's shapes,
# features of std init_stddev rounded to bf16, seed 0): the reading follows
# the draws.  Over keys 0-7 (scripts/bf16_recipe_spread.py on an H100,
# scripts/jax_apps.py --bf16_keys on the CPU; PERF.md) the shared draws read
# 0.00382 +- 0.00039 against JAX's 0.00380 +- 0.00043, each package's own
# 0.00375 +- 0.00059 against 0.00359 +- 0.00027.
APPS_BF16 = dict(
    dataset=dict(batch_size=2 ** 12, total_samples=2 ** 15, surface_stddev=0.05,
                 bound_buffer=0.4, trunc_dist=0.2),
    loss=dict(sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0, trunc_dist=0.2),
    train={"optimizer": "adam", "learning_rate": 5e-3, "epochs": 150, "max_epochs_in_level": 50,
           "grid_training_mode": "coordinate+joint"},
    eval_seed=3)
APPS_BF16_MAX_MAE = 0.03
APPS_BF16_MARGIN = 0.30


def apps_bf16_cfg(bound):
    """tests/test_train_e2e.py:129-138's model over ``bound``."""
    return {"spatial_dim": 3,
            "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
                     "feature_dtype": "bfloat16", "bound": bound, "base_cell_size": 0.5,
                     "per_level_scale": 2.0, "n_levels": 2},
            "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                        "pos_invariant": True, "fix": False, "pretrained_model": None},
            "pose": {"optimize": False, "num_poses": 1}}


# Phase 10 (c): build_submaps --synthetic's final mesh against the room
# (as the SLAM demo scores its mesh), and align_submaps --atlas --method
# miso --use_sdf's perturbation and alignment at its defaults.
APPS_MESH_METRICS = dict(n_points=100000, threshold=0.05, truncation=0.5)
APPS_ALIGN = dict(noise_deg=3.0, noise_m=0.15, iters=150, lr=5e-3, seed=0)


# A bf16 table's gradient is its float32 gradient rounded once to bf16: the
# kernel sums in float32 scratch copies, the plain version in float32 by
# index_add_, in another order.  Where the two float32 sums straddle a bf16
# rounding boundary they round to neighbours one bf16 step apart, so each
# entry is held to the plain version's float32 gradient within half a bf16
# step of that entry (at most 2^-8 of it) beyond 1e-4 of the largest entry.
BF16_HALF_STEP = 2.0 ** -8


def _check_bf16_grad(name, got, ref32, errs):
    """A bf16 table gradient against the plain version's float32 gradient:
    the largest excess of |kernel - plain| over half a bf16 step of the plain
    entry, within 1e-4 of the largest entry."""
    check(got.dtype == torch.bfloat16, f"{name}: gradient is {got.dtype}, not bfloat16")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    excess = ((got.float() - ref32).abs() - BF16_HALF_STEP * ref32.abs()).clamp(min=0)
    err = float(excess.max()) if excess.numel() else 0.0
    scale = float(ref32.abs().max()) if ref32.numel() else 0.0
    errs[name] = err
    check(err <= GRAD_RTOL_OF_MAX * max(scale, 1e-6),
          f"{name}: |kernel - plain| exceeds half a bf16 step by {err:.3e}, max |plain| = "
          f"{scale:.3e}")
    log(f"  {name}: |kernel - plain| beyond half a bf16 step {err:.3e} (tol "
        f"{GRAD_RTOL_OF_MAX} x {scale:.3e}) ok")


def _bf16_interp_check(name, grid, x, bound, size, errs, seed):
    """A bf16 table through the interp forward and all three backward modes
    against the plain versions on the same table."""
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain,
                                                 grid_interpolate_plain)
    n = x.shape[0]
    got = grid_interpolate_cuda(grid, x, bound, size)
    check(got.dtype == torch.float32 and got.shape == (n, grid.shape[-1]),
          f"interp_{name}: output {got.dtype} {tuple(got.shape)}")
    if n:
        _check_values(f"interp_{name}", got, grid_interpolate_plain(grid, x, bound, size), errs)
    cot = torch.randn((n, grid.shape[-1]), generator=torch.Generator(
        device=x.device).manual_seed(seed), device=x.device)
    r_grid, r_x = grid_interpolate_grad_plain(grid.float(), x, bound, cot, size)
    d_grid, d_x = grid_interpolate_grad_cuda(grid, x, bound, cot, size)
    _check_bf16_grad(f"interp_grad_{name}_table", d_grid, r_grid, errs)
    only, none = grid_interpolate_grad_cuda(grid, x, bound, cot, size, need_x=False)
    check(none is None, "need_x=False returned a points' gradient")
    _check_bf16_grad(f"interp_grad_{name}_table_only", only, r_grid, errs)
    none, p_x = grid_interpolate_grad_cuda(grid, x, bound, cot, size, need_grid=False)
    check(none is None and p_x.shape == (n, 3), "points-only mode: wrong outputs")
    if n:
        _check_grad(f"interp_grad_{name}_points", d_x, r_x, errs)
        _check_grad(f"points_only_{name}", p_x, r_x, errs)


def _bf16_times(grid32, x, bound, cot):
    """One level's calls with its float32 table and the same table in bf16,
    taken in turns: forward, backward table only, with the points' gradient,
    points only (call ms by CUDA events, device ms by the profiler), the bf16
    plain version, grid_sample on the bf16 volume (forward; backward, the
    table's gradient), and each call's bound at its table's element size."""
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda,
                                                 grid_interpolate_grad_plain,
                                                 grid_interpolate_plain)
    grid16 = grid32.to(torch.bfloat16)
    calls = {
        "fwd": lambda g: grid_interpolate_cuda(g, x, bound),
        "grad": lambda g: grid_interpolate_grad_cuda(g, x, bound, cot, need_x=False),
        "grad_x": lambda g: grid_interpolate_grad_cuda(g, x, bound, cot),
        "points_only": lambda g: grid_interpolate_grad_cuda(g, x, bound, cot,
                                                            need_grid=False)}
    plains = {
        "fwd": lambda: grid_interpolate_plain(grid16, x, bound),
        "grad": lambda: grid_interpolate_grad_plain(grid16, x, bound, cot, need_x=False),
        "grad_x": lambda: grid_interpolate_grad_plain(grid16, x, bound, cot),
        "points_only": lambda: grid_interpolate_grad_plain(grid16, x, bound, cot,
                                                           need_grid=False)}
    rec = {"fwd_path_bf16": _fwd_path(grid16, x.shape[0]),
           "fwd_path_f32": _fwd_path(grid32, x.shape[0])}
    with torch.no_grad():
        for key, call in calls.items():
            t = {}
            for label, g in (("f32", grid32), ("bf16", grid16), ("bf16", grid16),
                             ("f32", grid32)):
                t.setdefault(label + "_ms", []).append(cuda_ms(lambda: call(g)))
            r = {k: min(v) for k, v in t.items()}
            r["f32_device_ms"] = _kernel_device_ms(lambda: call(grid32))
            r["bf16_device_ms"] = _kernel_device_ms(lambda: call(grid16))
            r["plain_ms"] = cuda_ms(plains[key])
            need_x = key in ("grad_x", "points_only")
            r["bound_ms"], r["bound_by"] = _interp_bounds(grid16, x, need_x)
            r["f32_bound_ms"] = _interp_bounds(grid32, x, need_x)[0]
            rec[key] = r
    # grid_sample takes its sampling grid in its input's dtype: the points go
    # in as bf16, so this is the time of a like call, not of the same function
    # to float32 precision.
    vol, coords = _grid_sample_inputs(grid16, x, bound)
    coords = coords.to(torch.bfloat16)
    with torch.no_grad():
        rec["fwd"]["library_ms"] = cuda_ms(lambda: _grid_sample(vol, coords))
    vol_r = vol.clone().requires_grad_()
    out = _grid_sample(vol_r, coords)
    gout = cot.T.reshape(out.shape).to(torch.bfloat16).contiguous()
    rec["grad"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(out, vol_r, gout,
                                                                    retain_graph=True))
    return rec


def phase_bf16_kernels():
    """Phase 10 (a): every kernel path a bf16 table takes against its plain
    version on the same table (ScanNet widths, 1e6 points, and the edge
    cases of the float32 checks), a table of another dtype and mixed levels
    raising, and the bf16 calls' times beside float32's."""
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_plain)
    from miso_tpu_torch.ops.tiled_interp import (
        INTERP_STAGED_BLOCKS, grid_interpolate_cuda, grid_interpolate_per_point_cuda,
        grid_interpolate_per_point_grad_cuda, grid_interpolate_per_point_grad_plain,
        grid_interpolate_per_point_plain, grid_interpolate_plain, smem_budget, table_bytes)
    errs, times = {}, {}
    bf16 = torch.bfloat16
    g = SCANNET_MODEL["grid"]
    fine_cell = g["base_cell_size"] / g["per_level_scale"]
    dev = torch.device("cuda")
    with torch.no_grad():
        cases = [("fine_F4_bf16", g["bound"], fine_cell, 4, N_POINTS),
                 ("coarse_F4_bf16", g["bound"], g["base_cell_size"], 4, N_POINTS),
                 ("coarse_F1_bf16", g["bound"], g["base_cell_size"], 1, N_POINTS),
                 ("coarse_F12_bf16", g["bound"], g["base_cell_size"], 12, N_POINTS),
                 ("coarse_F3_bf16", g["bound"], g["base_cell_size"], 3, N_POINTS),
                 ("mesh_fine_bf16", MESH_BOUND, 0.1, 4, 2 ** 15)]
        for seed, (name, bl, cell, fdim, n) in enumerate(cases, start=300):
            grid, x, bound = _grid_case(bl, cell, fdim, n, seed)
            grid = grid.to(bf16)
            log(f"  interp {name}: grid {tuple(grid.shape)} bf16, {n} points, forward path "
                f"{_fwd_path(grid, n)}")
            _bf16_interp_check(name, grid, x, bound, None, errs, seed + 50)
        grid, x, bound = _grid_case(g["bound"], fine_cell, 4, N_POINTS, 310)
        grid = grid.to(bf16)
        for k in (0, 1):
            _bf16_interp_check(f"fine_F4_bf16_n{k}", grid, x[:k].contiguous(), bound, None,
                               errs, 311)
        # Padded storage with a logical size (the atlas's slots) at both levels.
        for fdim, cell in ((4, fine_cell), (4, g["base_cell_size"]), (3, g["base_cell_size"])):
            grid, x, bound = _grid_case(g["bound"], cell, fdim, N_POINTS, 320 + fdim)
            padded = 10.0 * torch.randn((grid.shape[0] + 3, grid.shape[1] + 2,
                                         grid.shape[2] + 1, fdim), device=dev)
            padded[:grid.shape[0], :grid.shape[1], :grid.shape[2]] = grid
            padded = padded.to(bf16)
            size = torch.tensor(grid.shape[:3], dtype=torch.int32, device=dev)
            level = "coarse" if cell == g["base_cell_size"] else "fine"
            log(f"  interp {level} sized F={fdim} bf16: storage {tuple(padded.shape)}, forward "
                f"path {_fwd_path(padded, N_POINTS)}")
            _bf16_interp_check(f"{level}_sized_F{fdim}_bf16", padded, x, bound, size, errs,
                               330 + fdim)
        # A bf16 table just under and just over the forward's staging budget.
        rows = smem_budget(INTERP_STAGED_BLOCKS) // 8
        for name, z in (("budget_under_bf16", rows // 64), ("budget_over_bf16", rows // 64 + 1)):
            grid, x, bound = _shaped_case((8, 8, z, 4), N_POINTS, 340)
            grid = grid.to(bf16)
            got = _fwd_path(grid, N_POINTS)
            check(got == ("staged" if name == "budget_under_bf16" else "pairs"),
                  f"interp {name}: {table_bytes(grid)} B taken {got}")
            log(f"  interp {name}: grid {tuple(grid.shape)} ({table_bytes(grid)} B), forward "
                f"path {got}")
            _check_values(f"interp_{name}", grid_interpolate_cuda(grid, x, bound),
                          grid_interpolate_plain(grid, x, bound), errs)

        # The slot-id mode on every SLOT_CASES shape.
        for i, (name, pad, F, sizes, n) in enumerate(SLOT_CASES):
            stacked, ids, x, bounds, sz = slot_case(pad, F, sizes, n, 350 + i)
            stacked = stacked.to(bf16)
            tag = f"{name}_bf16"
            got = grid_interpolate_per_point_cuda(stacked, ids, x, bounds, sz)
            check(got.shape == (n, F) and got.dtype == torch.float32,
                  f"slot_{tag}: output {got.dtype} {tuple(got.shape)}")
            if n:
                _check_values(f"slot_{tag}", got, grid_interpolate_per_point_plain(
                    stacked, ids, x, bounds, sz), errs)
            cot = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(
                360 + i), device=dev)
            r_st, r_x = grid_interpolate_per_point_grad_plain(stacked.float(), ids, x, bounds,
                                                              sz, cot)
            d_st, d_x = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot)
            _check_bf16_grad(f"slot_grad_{tag}_table", d_st, r_st, errs)
            only, _ = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot,
                                                           need_x=False)
            _check_bf16_grad(f"slot_grad_{tag}_table_only", only, r_st, errs)
            _, p_x = grid_interpolate_per_point_grad_cuda(stacked, ids, x, bounds, sz, cot,
                                                          need_grid=False)
            if n:
                _check_grad(f"slot_grad_{tag}_points", d_x, r_x, errs)
                _check_grad(f"slot_points_only_{tag}", p_x, r_x, errs)
            if name == "quad_fine_F4":
                st32 = stacked.float()
                args16 = (stacked, ids, x, bounds, sz)
                args32 = (st32, ids, x, bounds, sz)
                fwd_b = _slot_bounds(*args16, points_only=False)
                bwd_b = _slot_bounds(*args16, points_only=True)
                times["slot_" + name] = dict(
                    points=n, storage=list(pad) + [F],
                    fwd=dict(
                        f32_device_ms=_kernel_device_ms(
                            lambda: grid_interpolate_per_point_cuda(*args32),
                            "grid_interp_forward_kernel"),
                        bf16_device_ms=_kernel_device_ms(
                            lambda: grid_interpolate_per_point_cuda(*args16),
                            "grid_interp_forward_kernel"),
                        bf16_ms=cuda_ms(lambda: grid_interpolate_per_point_cuda(*args16)),
                        plain_ms=cuda_ms(lambda: grid_interpolate_per_point_plain(*args16)),
                        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None),
                    points_only=dict(
                        f32_device_ms=_kernel_device_ms(
                            lambda: grid_interpolate_per_point_grad_cuda(
                                *args32, cot, need_grid=False), "grid_interp_points_grad"),
                        bf16_device_ms=_kernel_device_ms(
                            lambda: grid_interpolate_per_point_grad_cuda(
                                *args16, cot, need_grid=False), "grid_interp_points_grad"),
                        bf16_ms=cuda_ms(lambda: grid_interpolate_per_point_grad_cuda(
                            *args16, cot, need_grid=False)),
                        plain_ms=cuda_ms(lambda: grid_interpolate_per_point_grad_plain(
                            *args16, cot, need_grid=False)),
                        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None))

        # The fused kernel: the ScanNet widths (coarse level staged, fine from
        # L2), padded levels with ignore_level, and base.yaml's shape.
        scannet_cells = [g["base_cell_size"] / g["per_level_scale"] ** l
                         for l in range(g["n_levels"])]
        grids, x, bound, decoder = _setup(g["bound"], scannet_cells, 4, 64, 1, 1, N_POINTS,
                                          seed=370)
        grids16 = [t.to(bf16) for t in grids]
        occ = _fused_check("scannet_bf16", (grids16, x, bound, decoder), errs)
        padded, sizes = _pad(grids, 371)
        ignore = torch.tensor([0.0, 1.0], device=dev)
        _fused_check("scannet_sized_ignore_bf16",
                     ([t.to(bf16) for t in padded], x, bound, decoder, sizes, ignore), errs)
        g1, x1, b1, d1 = _setup([[-1.0, 1.0]] * 3, [0.5], 1, 8, 0, 1, 4099, seed=372)
        _fused_check("base_F1_bf16", ([t.to(bf16) for t in g1], x1, b1, d1), errs)
        (t32_ms, t16_ms) = ([], [])
        for label in ("f32", "bf16", "bf16", "f32"):
            gs = grids if label == "f32" else grids16
            (t32_ms if label == "f32" else t16_ms).append(cuda_ms(
                lambda: fused_interp_decode_cuda(gs, x, bound, decoder)))
        (tb, tby), _ = _fused_bounds(grids16, x, decoder)
        times["fused_scannet"] = dict(
            f32_ms=min(t32_ms), bf16_ms=min(t16_ms),
            f32_device_ms=_kernel_device_ms(lambda: fused_interp_decode_cuda(
                grids, x, bound, decoder)),
            bf16_device_ms=_kernel_device_ms(lambda: fused_interp_decode_cuda(
                grids16, x, bound, decoder)),
            plain_ms=cuda_ms(lambda: fused_interp_decode_plain(grids16, x, bound, decoder)),
            bound_ms=tb, bound_by=tby, f32_bound_ms=_fused_bounds(grids, x, decoder)[0][0],
            levels_staged=occ["staged"], library_ms=None)

        # What the kernels refuse: a table of another dtype, levels of two.
        for what, call in (
                ("interp", lambda: grid_interpolate_cuda(grids[0].half(), x, bound)),
                ("slot-id", lambda: grid_interpolate_per_point_cuda(
                    grids[0].half()[None], torch.zeros(x.shape[0], dtype=torch.int32,
                                                       device=dev), x, bound[None],
                    torch.tensor([grids[0].shape[:3]], dtype=torch.int32, device=dev))),
                ("fused", lambda: fused_interp_decode_cuda([t.half() for t in grids], x, bound,
                                                           decoder)),
                ("fused mixed", lambda: fused_interp_decode_cuda([grids[0], grids16[1]], x,
                                                                 bound, decoder))):
            try:
                call()
            except TypeError as e:
                log(f"  {what}: refused ({e})")
            else:
                raise SmokeFailure(f"{what}: a float16 or mixed table was not refused")

    # bf16 against float32 at the ScanNet levels with 1e6 points.
    for seed, (name, bl, cell, n) in enumerate(INTERP_SHAPES[:2], start=380):
        grid, x, bound = _grid_case(bl, cell, 4, n, seed)
        cot = torch.randn((n, 4), generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
        rec = _bf16_times(grid, x, bound, cot)
        times[name] = rec
        log(f"  {name} {tuple(grid.shape)}, {n} points, forward path bf16 "
            f"{rec['fwd_path_bf16']} (float32 {rec['fwd_path_f32']}): " + "; ".join(
                f"{k} bf16 {v['bf16_ms']:.4f} ms (device {v['bf16_device_ms']:.4f}) against "
                f"float32 {v['f32_ms']:.4f} (device {v['f32_device_ms']:.4f}), bound "
                f"{v['bound_ms']:.4f} ({v['f32_bound_ms']:.4f}), plain {v['plain_ms']:.4f}"
                + (f", grid_sample bf16 {v['library_ms']:.4f}" if "library_ms" in v else "")
                for k, v in ((k, rec[k]) for k in ("fwd", "grad", "grad_x", "points_only"))))
    f = times["fused_scannet"]
    log(f"  fused ScanNet widths bf16 {f['bf16_ms']:.4f} ms (device {f['bf16_device_ms']:.4f}) "
        f"against float32 {f['f32_ms']:.4f} (device {f['f32_device_ms']:.4f}), bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}), plain {f['plain_ms']:.4f}, levels staged "
        f"{f['levels_staged']}")
    q = times["slot_quad_fine_F4"]
    log(f"  slot-id quad_fine_F4 bf16: forward device {q['fwd']['bf16_device_ms']:.4f} ms "
        f"(float32 {q['fwd']['f32_device_ms']:.4f}), points-only device "
        f"{q['points_only']['bf16_device_ms']:.4f} ({q['points_only']['f32_device_ms']:.4f}), "
        f"bounds {q['fwd']['bound_ms']:.5f} / {q['points_only']['bound_ms']:.5f}")
    return errs, times


# The JAX package's CPU runs of phase 10's recipes (JAX_PLATFORMS=cpu python3
# scripts/jax_apps.py, 40-60 s on 8 CPU cores): test_bf16_features's MAE;
# demo/build_submaps.py --synthetic's final 256^3 mesh against the room
# (APPS_MESH_METRICS); that atlas aligned from 3.000 deg / 15.0 cm as the
# port's align_submaps --atlas --method miso --use_sdf aligns it (the JAX
# demo has no --atlas path: the script runs the port's procedure on the JAX
# package); demo/align_submaps.py --method miso --use_sdf on its own
# synthetic atlas.  The build_submaps atlas does not realign in either
# package (ROADMAP Queue 3): its readings are held to the JAX run's within
# APPS_ALIGN_ATLAS_MARGIN, and the synthetic atlas, whose alignment
# converges, to a third of the perturbation.
JAX_APPS_BF16_MAE = 0.004309265408664942
JAX_APPS_BUILD_FSCORE = 14.693239820262196
JAX_APPS_BUILD_CHAMFER_CM = 14.9734768393772
JAX_APPS_ALIGN_AFTER = (52.186893463134766, 1.3256405591964722)
JAX_APPS_ALIGN_SYNTHETIC_AFTER = (0.36045199632644653, 0.012236502021551132)
APPS_FSCORE_MARGIN = 5.0
APPS_CHAMFER_MARGIN = 0.25
APPS_ALIGN_ATLAS_MARGIN = 0.25
# The other three demos at a small depth: their synthetic pretraining cut
# (full_slam_scannet.PRETRAIN_EPOCHS, full_slam_newer_college.ENCODER_EPOCHS)
# and these arguments.
APPS_SMALL_PRETRAIN = 60
APPS_SMALL_ENCODER = 30
APPS_SMALL_ARGS = {
    "full_slam_scannet": ["--synthetic", "--num_frames", "6", "--final_iters", "30",
                          "--mesh_resolution", "128"],
    "full_slam_newer_college": ["--synthetic", "--scene", "quad", "--num_frames", "6",
                                "--submap_size", "3", "--init_mode", "encode",
                                "--mesh_resolution", "128"],
    "encoder_init": ["--pretrain_epochs", "30", "--encoder_epochs", "20", "--eval_epochs",
                     "0", "5"],
}
APPS_DIR = os.path.join(ROOT, "results", "torch", "chip_smoke")


def apps_bf16_setup(seed=0, own_draws=False, device="cuda"):
    """The test_bf16_features recipe on ``device``: its icosphere dataset and
    a GridTrainer of a bf16 GridNet that starts from alt_draws(seed) (the
    draws scripts/jax_apps.py gives the JAX package), or with ``own_draws``
    from the port's own initializer seeded ``seed``."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import icosphere
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.trainer import GridTrainer
    r = APPS_BF16
    ds = Sdf3D(TriangleMesh(*icosphere(3, 0.6)), **r["dataset"])
    model = create_grid_net(apps_bf16_cfg(ds.bound.tolist()),
                            generator=torch.Generator().manual_seed(seed), device=device)
    if not own_draws:
        set_alt_draws(model, seed, std=apps_bf16_cfg(None)["grid"]["init_stddev"])
    check(all(f.dtype == torch.bfloat16 for f in model.features), "features are not bf16")
    return ds, GridTrainer(r["train"], model, make_loss(tsdf_loss_3d, **r["loss"]), ds)


@torch.no_grad()
def apps_bf16_mae(model, ds):
    """The recipe's reading: the SDF MAE on the valid samples of a fresh
    batch (numpy default_rng(APPS_BF16["eval_seed"]))."""
    b = ds.sample(np.random.default_rng(APPS_BF16["eval_seed"]))
    x = torch.as_tensor(b["coords"], device=model.features[0].device)
    pred = model(x).reshape(-1).float().cpu().numpy()
    valid = b["sdf_valid"].reshape(-1) > 0
    return float(np.abs(pred - b["sdf"].reshape(-1))[valid].mean())


def apps_bf16_training(counters):
    """Phase 10 (b): the test_bf16_features recipe on the card.  Every step
    launches the interp forward and backward on the bf16 tables (one each a
    level) and the decode; the tables stay bf16.  Gates: MAE under 0.03 and
    within APPS_BF16_MARGIN of the JAX CPU run's."""
    r = APPS_BF16
    ds, trainer = apps_bf16_setup()
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    model = trainer.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = _read_counts(counters)
    epochs, L = r["train"]["epochs"], model.num_levels
    want = dict(interp=L * epochs, interp_grad=L * epochs, decode=epochs, interp_points_grad=0,
                fused=0, interp_recompute_backward=0)
    for name, n in _exact(want).items():
        check(c[name] == n, f"bf16 training: {name} launched {c[name]} times, expected {n}")
    check(all(f.dtype == torch.bfloat16 for f in model.features), "training left bf16")
    mae = apps_bf16_mae(model, ds)
    log(f"  (b) bf16 training: {epochs} epochs in {seconds:.2f} s, MAE {mae:.6f} (the JAX "
        f"package's CPU run {JAX_APPS_BF16_MAE:.6f}); launches {c}")
    check(mae < APPS_BF16_MAX_MAE, f"bf16 training MAE {mae:.4f} not under {APPS_BF16_MAX_MAE}")
    check(abs(mae - JAX_APPS_BF16_MAE) <= APPS_BF16_MARGIN * JAX_APPS_BF16_MAE,
          f"bf16 training MAE {mae:.5f} not within {APPS_BF16_MARGIN:.0%} of the JAX CPU "
          "run's")
    return dict(mae=mae, seconds=seconds, launches=c, epochs=epochs)


def _run_cli(name, argv, counters, constants=()):
    """``miso_tpu_torch.demo.<name>.main(argv)`` on the card, counted, with
    module constants (module, name, value) set for the run; returns (its
    results, launches, seconds)."""
    import importlib
    saved = []
    for module, attr, value in constants:
        mod = importlib.import_module(f"miso_tpu_torch.demo.{module}")
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)
    try:
        demo = importlib.import_module(f"miso_tpu_torch.demo.{name}")
        torch.cuda.synchronize()
        _zero_counts(counters)
        t0 = time.perf_counter()
        res = demo.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)
    return res, _read_counts(counters), seconds


def _finite(tree):
    """Every number in a nested results dict is finite."""
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or bool(np.isfinite(tree))


def apps_clis(counters, card):
    """Phase 10 (c): the demo CLIs on the card.  build_submaps --synthetic at
    its defaults, its final mesh against the room (F-score within
    APPS_FSCORE_MARGIN points and Chamfer_L1 within APPS_CHAMFER_MARGIN of the
    JAX CPU run's); align_submaps --atlas on its grid_atlas.npz with --method
    miso --use_sdf at its defaults (both pose errors within
    APPS_ALIGN_ATLAS_MARGIN of the JAX CPU run's, which diverges) and
    align_submaps --method miso --use_sdf on its synthetic atlas (both pose
    errors under a third of the perturbation); the other three at a small
    depth (finite readings, their kernels launched)."""
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics
    from miso_tpu_torch.utils.sdf import read_ply
    report = {}
    build_dir = os.path.join(APPS_DIR, "build_submaps")
    res, c, sec = _run_cli("build_submaps", ["--synthetic", "--save_dir", build_dir], counters)
    mesh = TriangleMesh(*read_ply(os.path.join(build_dir, "mesh_final.ply")))
    m = mesh_reconstruction_metrics(mesh, TriangleMesh(*room_scene(5.0, seed=0)),
                                    **APPS_MESH_METRICS)
    report["build_submaps"] = dict(results=res, launches=c, seconds=sec, mesh=m)
    log(f"  (c) build_submaps --synthetic: {res['num_submaps']} submaps, {sec:.2f} s "
        f"(mapping {res['mapping_time_sec']:.2f} s; {card}); final mesh F-score "
        f"{m['F-score (%)']:.3f} %, Chamfer_L1 {m['Chamfer_L1 (cm)']:.3f} cm (the JAX package's "
        f"CPU run {JAX_APPS_BUILD_FSCORE:.3f} %, {JAX_APPS_BUILD_CHAMFER_CM:.3f} cm); "
        f"launches {c}")
    check(c["interp"] > 0 and c["interp_grad"] > 0 and c["decode"] > 0,
          f"build_submaps: kernels not launched ({c})")
    check(abs(m["F-score (%)"] - JAX_APPS_BUILD_FSCORE) < APPS_FSCORE_MARGIN,
          f"build_submaps F-score {m['F-score (%)']:.3f} not within {APPS_FSCORE_MARGIN} "
          "points of the JAX CPU run's")
    check(abs(m["Chamfer_L1 (cm)"] - JAX_APPS_BUILD_CHAMFER_CM)
          <= APPS_CHAMFER_MARGIN * JAX_APPS_BUILD_CHAMFER_CM,
          f"build_submaps Chamfer_L1 {m['Chamfer_L1 (cm)']:.3f} cm not within "
          f"{APPS_CHAMFER_MARGIN:.0%} of the JAX CPU run's")

    third = (APPS_ALIGN["noise_deg"] / 3, APPS_ALIGN["noise_m"] / 3)
    for name, atlas_args, jax_after in (
            ("align_submaps", ["--atlas", os.path.join(build_dir, "grid_atlas.npz")],
             JAX_APPS_ALIGN_AFTER),
            ("align_synthetic", [], JAX_APPS_ALIGN_SYNTHETIC_AFTER)):
        res, c, sec = _run_cli("align_submaps", atlas_args + [
            "--method", "miso", "--use_sdf", "--save_dir", os.path.join(APPS_DIR, name)],
            counters)
        after = (res["rot_rmse_deg_after"], res["trans_rmse_m_after"])
        met = after[0] < third[0] and after[1] < third[1]
        report[name] = dict(results=res, launches=c, seconds=sec, under_a_third=met)
        log(f"  (c) align_submaps {' '.join(atlas_args) or '(synthetic atlas)'} --method miso "
            f"--use_sdf: {res['rot_rmse_deg_before']:.4f} deg / "
            f"{100 * res['trans_rmse_m_before']:.3f} cm -> {after[0]:.4f} deg / "
            f"{100 * after[1]:.3f} cm in {sec:.2f} s ({card}; the JAX package's CPU run "
            f"{jax_after[0]:.4f} deg / {100 * jax_after[1]:.3f} cm); "
            f"{'' if met else 'not '}under a third of the perturbation; launches {c}")
        check(c["interp_slot"] > 0 and c["interp_slot_points_grad"] > 0 and c["decode"] > 0,
              f"{name}: kernels not launched ({c})")
        check(_finite(res), f"{name}: a non-finite reading")
        if atlas_args:
            for what, got, want in zip(("rotation", "translation"), after, jax_after):
                check(abs(got - want) <= APPS_ALIGN_ATLAS_MARGIN * want,
                      f"{name} --atlas: {what} RMSE {got:.4f} not within "
                      f"{APPS_ALIGN_ATLAS_MARGIN:.0%} of the JAX CPU run's {want:.4f}")
        else:
            check(met, f"{name}: left {after[0]:.4f} deg / {after[1]:.4f} m, not under a "
                  "third of the perturbation")

    constants = [("full_slam_scannet", "PRETRAIN_EPOCHS", APPS_SMALL_PRETRAIN),
                 ("full_slam_newer_college", "ENCODER_EPOCHS", APPS_SMALL_ENCODER)]
    kernels = {"full_slam_scannet": ("interp", "interp_grad", "decode"),
               "full_slam_newer_college": ("interp", "interp_grad", "interp_points_grad",
                                           "interp_slot", "interp_slot_points_grad", "decode"),
               "encoder_init": ("interp", "interp_grad", "decode")}
    for name, argv in APPS_SMALL_ARGS.items():
        res, c, sec = _run_cli(name, argv + ["--save_dir", os.path.join(APPS_DIR, name)],
                               counters, constants)
        report[name] = dict(results=res, launches=c, seconds=sec)
        if name == "encoder_init":
            reading = {k: v["mae_by_epoch"] for k, v in res.items()}
        else:
            reading = res["ate"]["ate_rmse"]
        log(f"  (c) {name} {' '.join(argv)}: {sec:.2f} s ({card}); "
            f"{'MAE' if name == 'encoder_init' else 'ATE'} {reading}; launches {c}")
        check(_finite(res), f"{name}: a non-finite reading in its results")
        missing = [k for k in kernels[name] if c[k] == 0]
        check(not missing, f"{name}: {missing} not launched")
    return report


def apps_live_system(counters, card):
    """Phase 10 (d)'s live view, on bf16 storage: phase 5's configuration
    with grid.feature_dtype bfloat16 and 4 keyframes a submap over 8 frames
    (two submaps), the Visualizer's live view on an ephemeral port and a bf16
    mesh every 4 frames; /state.json read back during the run; then the two
    submaps aligned (latent level 1, then the SDF, 10 iterations each)
    through the slot-id kernels on the bf16 storage, and the field meshed (as
    the Visualizer meshes it: a run of 8 frames leaves the stability under
    the observed query's 0.2).  Gates: the state has every frame, both submaps and their boxes;
    the storage stays bf16; every kernel of tracking, mapping, alignment and
    meshing launched."""
    import urllib.request
    from miso_tpu_torch.align.miso import align_multiple_submaps_hierarchical
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System
    from miso_tpu_torch.utils.sdf import save_mesh
    dev = torch.device("cuda")
    frames = 8
    cfg = slam_config()
    cfg["model"]["grid"]["feature_dtype"] = "bfloat16"
    cfg["system"].update({"submap_size": 4, "log_dir": os.path.join(APPS_DIR, "live")})
    cfg["visualizer"] = {"enable": True, "live": True, "live_port": 0, "mesh_vis_freq": 4,
                         "mesh_resolution": 96}
    mesh, ds = slam_sequence(frames)
    decoder = pretrain_decoder(mesh, cfg["model"], dev, epochs=APPS_SMALL_PRETRAIN)
    cfg["model"]["decoder"]["fix"] = True
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=4,
                      capacity=cfg["system"].get("submap_capacity"), device=dev)
    atlas.set_decoder(decoder, fixed=True)
    torch.cuda.synchronize()
    _zero_counts(counters)
    t0 = time.perf_counter()
    system = System(atlas, ds, ds, cfg, *ds.noisy_kf_pose_in_world(0), verbose=False)
    vis = system.visualizer
    try:
        while atlas.num_keyframes < frames:
            system.step()
        with urllib.request.urlopen(f"http://127.0.0.1:{vis.live.port}/state.json",
                                    timeout=10) as r:
            state = json.loads(r.read())
    finally:
        vis.quit()
    system.ensure_full_sync()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    c_run = _read_counts(counters)
    check(state.get("frame") == frames and state.get("num_submaps") == 2
          and len(state.get("submap_boxes", [])) == 2 and len(state.get("traj_est", [])) == frames
          and "mesh_edges" in state,
          f"live view state: frame {state.get('frame')}, submaps {state.get('num_submaps')}")
    check(all(f.dtype == torch.bfloat16 for f in atlas.params.features + atlas.params.stability),
          "the SLAM run left bf16 storage")
    _zero_counts(counters)
    t0 = time.perf_counter()
    align_multiple_submaps_hierarchical(atlas, level_iters=10, finetune_iters=10, lr=2e-3,
                                        align_loss="L2", latent_levels=[1], seed=0)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    c_align = _read_counts(counters)
    _zero_counts(counters)
    t0 = time.perf_counter()
    m = save_mesh(atlas.params, atlas.global_bound(), None, resolution=128)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    c_mesh = _read_counts(counters)
    log(f"  (d) live view over a bf16 System run: {frames} frames, 2 submaps in {run_s:.2f} s "
        f"({card}); /state.json: frame {state['frame']}, {len(state['traj_est'])} keyframes, "
        f"{len(state['submap_boxes'])} boxes, {len(state['mesh_edges'])} mesh edges; launches "
        f"{c_run}; alignment {align_s:.2f} s, launches {c_align}; mesh 128^3 "
        f"{mesh_s:.2f} s, {len(m.vertices)} vertices, launches {c_mesh}")
    for what, c, names in (("SLAM", c_run, ("interp", "interp_grad", "decode")),
                           ("alignment", c_align, ("interp_slot", "interp_slot_points_grad")),
                           ("mesh", c_mesh, ("interp", "decode"))):
        missing = [k for k in names if c[k] == 0]
        check(not missing, f"bf16 {what}: {missing} not launched")
    check(len(m.vertices) > 0, "the bf16 atlas's mesh is empty")
    return dict(frames=frames, run_s=run_s, align_s=align_s, mesh_s=mesh_s,
                launches=[c_run, c_align, c_mesh], state_keys=sorted(state))


def phase_apps(card):
    """Phase 10 (b)-(d) but phase 6's bf16 mesh: bf16 training, the demo CLIs
    and a live view over a bf16 SLAM run."""
    counters = kernel_counters()
    os.makedirs(APPS_DIR, exist_ok=True)
    training = apps_bf16_training(counters)
    clis = apps_clis(counters, card)
    live = apps_live_system(counters, card)
    launches = [training["launches"], *(v["launches"] for v in clis.values()),
                *live["launches"]]
    return dict(training=training, clis=clis, live=live, launches=launches)


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
    atlas_errs, atlas_times = phase_atlas_query()
    slot_errs, slot_times = phase_slot_kernels()
    errs.update(slot_errs)
    errs.update(interp_errs)
    errs.update(decode_errs)
    errs.update(grad2_errs)
    errs.update(atlas_errs)

    log("phase 3: main path (bench.py's mapping train step: default decode, then fused)")
    main_report, fused_report = phase_main_path()

    log("phase 4: synthetic mesh path (default decode)")
    mesh_report, mesh_errs = phase_mesh()
    errs.update(mesh_errs)

    log("phase 5: SLAM on System and GridAtlas (demo/full_slam_scannet.py --synthetic)")
    t0 = time.perf_counter()
    slam_report, slam_errs = phase_slam(card)
    slam_report["seconds"] = time.perf_counter() - t0
    errs.update(slam_errs)

    log("phase 6: two-submap SLAM (demo/full_slam_newer_college.py --synthetic --scene quad "
        f"--num_frames {QUAD_FRAMES} --submap_size {QUAD_SUBMAP_SIZE}), consolidation, mesh")
    t0 = time.perf_counter()
    quad_report = phase_quad(card)
    quad_report["seconds"] = time.perf_counter() - t0

    log("phase 7: submap alignment (demo/align_submaps.py --method miso --use_sdf)")
    t0 = time.perf_counter()
    align_report, align_errs = phase_align(card)
    align_report["seconds"] = time.perf_counter() - t0
    errs.update(align_errs)

    log("phase 8: encoder initialization (demo/encoder_init.py, the in-system recipe, "
        "the quad run with --init_mode encode)")
    t0 = time.perf_counter()
    encode_report = phase_encode(card, quad_report["ate_prefusion"])
    encode_report["seconds"] = time.perf_counter() - t0

    log("phase 9: the alternative models (iSDF, hash grid, PointSDF, VM grid; a 2D grid)")
    t0 = time.perf_counter()
    alt_report = phase_alt(card)
    alt_report["seconds"] = time.perf_counter() - t0

    log("phase 10: bf16 feature storage and the apps")
    t0 = time.perf_counter()
    bf16_errs, bf16_times = phase_bf16_kernels()
    apps_report = phase_apps(card)
    apps_report["seconds"] = time.perf_counter() - t0
    apps_report["kernel_times"] = bf16_times

    log("report")
    print(json.dumps({"card": card, "build_s": build_s, "max_abs_err": {**errs, **bf16_errs},
                      "fused_kernel": times, "interp_kernels": interp_times,
                      "decode_kernel": decode_t, "atlas_query": atlas_times,
                      "slot_kernels": slot_times, "main_path": main_report,
                      "main_path_fused": fused_report, "mesh_path": mesh_report,
                      "slam_path": slam_report, "quad_path": quad_report,
                      "align_path": align_report, "encode_path": encode_report,
                      "alt_models": alt_report, "bf16_and_apps": apps_report}), flush=True)

    online, quad = slam_report["online"], quad_report
    path_launches = [main_report["launches"], mesh_report["train_launches"],
                     mesh_report["lattice_launches"], online["launches"],
                     online["refine_launches"], online["mesh"]["launches"],
                     slam_report["lm"]["launches"], quad["launches"],
                     quad["fusion"]["align_launches"], quad["fusion"]["fuse_launches"],
                     quad["consolidation"]["launches"], quad["mesh"]["launches"],
                     quad["mesh_bf16"]["launches"],
                     align_report["launches"],
                     *(r["launches"] for r in align_report["baselines"].values()),
                     *encode_report["launches"], *alt_report["launches"],
                     *apps_report["launches"]]

    def launches(name):
        """The launches on the paths that run the kernel: phase 3's
        default-decode run, phase 4's training and lattice, phase 5's online
        run, refinement, observed mesh and LM run, phase 6's online run,
        alignment, fuse, consolidation and fused mesh, phase 7's alignment,
        phase 8's encoder pretraining, one-shot prediction, optimize runs,
        in-system runs and quad run, phase 9's training and lattices, and
        phase 10's: bf16 training, the demo CLIs, the bf16 SLAM run with its
        live view, alignment and mesh, and phase 6's bf16 fused mesh."""
        return sum(c[name] for c in path_launches)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    def worst(*prefixes, bf16=()):
        """The largest error of a kernel's checks at its paths' shapes: the
        ScanNet widths of phase 2 and the mesh path's own of phase 4, and its
        bf16 checks of phase 10 (``bf16``: their prefixes; a bf16 table's
        gradient counts its excess over half a bf16 step)."""
        return max([v for k, v in errs.items() if k.startswith(prefixes)]
                   + [v for k, v in bf16_errs.items() if k.startswith(prefixes + bf16)])

    def bf16_entry(t):
        """A bf16 time record of phase 10 (a) in the kernels line's keys."""
        return {"ms": t["bf16_ms"], "device_ms": t["bf16_device_ms"],
                "f32_ms": t.get("f32_ms"), "f32_device_ms": t["f32_device_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms")}

    fine, coarse = interp_times["scannet_fine"], interp_times["scannet_coarse"]
    # The grad kernel's entry: the fine level's table-only call; beside it the
    # call with the points' gradient (the default-decode step's) and the
    # coarse level's table-only call, which spreads its atomics over copies.
    backward = entry("grid_interp_backward", "miso_tpu_torch/csrc/grid_interp.cu",
                     "miso_tpu/ops/pallas_interp.py:268", launches("interp_grad"),
                     worst("interp_grad_fine_F4", "interp_grad_coarse_F4", "mesh_grad_",
                           "slam_grad_", bf16=("interp_grad_",)),
                     fine["grad"])
    backward.update(points_grad_ms=fine["grad_x"]["ms"],
                    points_grad_bound_ms=fine["grad_x"]["bound_ms"],
                    coarse_ms=coarse["grad"]["ms"], coarse_bound_ms=coarse["grad"]["bound_ms"],
                    coarse_copies=coarse["copies"],
                    bf16_fine=bf16_entry(bf16_times["scannet_fine"]["grad"]),
                    bf16_fine_with_points=bf16_entry(bf16_times["scannet_fine"]["grad_x"]),
                    bf16_coarse=bf16_entry(bf16_times["scannet_coarse"]["grad"]))
    # The fused kernel's entry: its call at the ScanNet widths, bound by its
    # 3xTF32 operations; beside it the FP32 bound, the kernel's device time,
    # the sum of the parts it fuses in the same call and which levels it
    # staged.  The interp forward's: the fine level's call, and beside it the
    # coarse level's, the path each took and the lattice chunk's calls.
    fused = entry("fused_interp_decode", "miso_tpu_torch/csrc/fused_interp_decode.cu",
                  "miso_tpu/ops/pallas_decode.py:186", fused_report["launches"]["fused"],
                  worst("fused_"), times)
    fb = bf16_times["fused_scannet"]
    fused.update(bound_note="3xTF32 tensor-core operations", fp32_bound_ms=times["fp32_bound_ms"],
                 device_ms=times["device_ms"], parts_sum_ms=times["parts_sum_ms"],
                 levels_staged=times["levels_staged"],
                 bf16={"ms": fb["bf16_ms"], "device_ms": fb["bf16_device_ms"],
                       "f32_ms": fb["f32_ms"], "f32_device_ms": fb["f32_device_ms"],
                       "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
                       "bound_by": fb["bound_by"], "levels_staged": fb["levels_staged"],
                       "library_ms": None})
    forward = entry("grid_interp_forward", "miso_tpu_torch/csrc/grid_interp.cu",
                    "miso_tpu/ops/pallas_interp.py:196", launches("interp"),
                    worst("interp_fine_F4", "interp_coarse_F4", "mesh_interp_", "slam_interp_",
                          bf16=("interp_fine", "interp_coarse", "interp_mesh", "interp_budget")),
                    fine["fwd"])
    lattice = mesh_report["lattice_interp_fwd"]
    forward.update(path=fine["fwd_path"], device_ms=fine["fwd"]["device_ms"],
                   coarse_path=coarse["fwd_path"], coarse_ms=coarse["fwd"]["ms"],
                   coarse_device_ms=coarse["fwd"]["device_ms"],
                   coarse_bound_ms=coarse["fwd"]["bound_ms"],
                   lattice_device_ms={k: v["device_ms"] for k, v in lattice.items()},
                   lattice_paths={k: v["path"] for k, v in lattice.items()},
                   bf16_fine=dict(bf16_entry(bf16_times["scannet_fine"]["fwd"]),
                                  path=bf16_times["scannet_fine"]["fwd_path_bf16"]),
                   bf16_coarse=dict(bf16_entry(bf16_times["scannet_coarse"]["fwd"]),
                                    path=bf16_times["scannet_coarse"]["fwd_path_bf16"]))
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
                                    for k in ("scannet_fine", "scannet_coarse")},
                       bf16_scannet_1e6={k: bf16_entry(bf16_times[k]["points_only"])
                                         for k in ("scannet_fine", "scannet_coarse")})
    # The slot-id mode's entries: the forward and the points-only backward at
    # phase 6's alignment shape (its fine level, 8192 points a pair); beside
    # them the align phase's fine level at its 38,400 points.
    qf, af = slot_times["quad_fine_F4"], slot_times["align_fine_F4"]
    slot_fwd = entry("grid_interp_slot_forward", "miso_tpu_torch/csrc/grid_interp.cu",
                     "miso_tpu/ops/pallas_interp.py:196", launches("interp_slot"),
                     worst("slot_quad", "slot_align", "slot_mixed", "align_slot"), qf["fwd"])
    qb = bf16_times["slot_quad_fine_F4"]
    slot_fwd.update(mode="slot-id (grid_interpolate_per_point_cuda)", points=qf["points"],
                    device_ms=qf["fwd"]["device_ms"],
                    align_fine={k: af["fwd"][k] for k in ("ms", "device_ms", "plain_ms",
                                                          "bound_ms")},
                    bf16={k: qb["fwd"][k] for k in ("bf16_ms", "bf16_device_ms", "f32_device_ms",
                                                    "plain_ms", "bound_ms")})
    slot_po = entry("grid_interp_slot_points_backward", "miso_tpu_torch/csrc/grid_interp.cu",
                    "miso_tpu/ops/pallas_interp.py:268", launches("interp_slot_points_grad"),
                    worst("slot_points_only_", "slot_grad_"), qf["points_only"])
    slot_po.update(mode="slot-id, need_grid=False (grid_interpolate_per_point_grad_cuda)",
                   points=qf["points"], device_ms=qf["points_only"]["device_ms"],
                   table_and_points_ms=qf["table_and_points_ms"],
                   align_fine={k: af["points_only"][k] for k in ("ms", "device_ms", "plain_ms",
                                                                 "bound_ms")},
                   bf16={k: qb["points_only"][k] for k in ("bf16_ms", "bf16_device_ms",
                                                           "f32_device_ms", "plain_ms",
                                                           "bound_ms")})
    kernels = [fused, forward, backward, points_only, slot_fwd, slot_po,
               entry("mlp_decode", "miso_tpu_torch/csrc/mlp_decode.cu",
                     "miso_tpu/ops/pallas_decode.py:107", launches("decode"),
                     worst("decode_scannet", "mesh_decode_", "slam_decode_"), decode_t)]
    tpu_kernels = [
        {"replaces": "miso_tpu/ops/pallas_decode.py:186", "name": "_fused_kernel",
         "status": "ported and checked", "port": "fused_interp_decode"},
        {"replaces": "miso_tpu/ops/pallas_decode.py:107", "name": "_decode_kernel",
         "status": "ported and checked", "port": "mlp_decode"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:196", "name": "_interp_kernel",
         "status": "ported and checked", "port": "grid_interp_forward, grid_interp_slot_forward"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:268", "name": "_interp_grad_kernel",
         "status": "ported and checked",
         "port": "grid_interp_backward, grid_interp_points_backward, "
                 "grid_interp_slot_points_backward"},
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
