#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miso_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

  1. build   - compile every CUDA kernel of the main path from
               miso_tpu_torch/csrc with nvcc (sm_90a) and load it;
  2. kernels - hold each kernel to its plain PyTorch version on the card:
               the fused interp+decode kernel at the ScanNet mapping widths
               with 1e6 points (5 % out of bound), again with ignore_level
               and padded storage with logical sizes, at an off-default shape
               (3 levels, F=8, 3 hidden layers, out_dim 3) and at base.yaml's
               (1 level, F=1, no hidden stack); the autograd.Function's
               gradients against the plain version's;
  3. main    - the mapping train step that bench.py drives, at full ScanNet
               width: GridNet (2 levels, F=4, 0.5 m / 0.1 m cells, 64x1
               decoder, 372 poses, decoder.impl "pallas"), mapping_loss with
               L1 SDF + free space, masked Adam, 4 rotating 1e6-point batches,
               3 warm-up and 20 timed steps;
  4. report  - the card, step times, kernel times against the bound, and the
               kernels line; the last line is {"ok": true, "device": ...}.

Imports torch, numpy and miso_tpu_torch only.  Needs one CUDA card.
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
    """Least time for one call: bytes (each input read once, the output written
    once) over HBM bandwidth vs FP32 operations over the FP32 peak."""
    n = x.shape[0]
    fdim = grids[0].shape[-1]
    nbytes = (x.numel() + n * out_dim + sum(g.numel() for g in grids)
              + sum(W.numel() + b.numel() for W, b in decoder)) * 4
    mlp_fma = sum(W.shape[0] * W.shape[1] for W, _ in decoder)
    lerp_fma = 8 * len(grids) * fdim
    flops = 2.0 * (mlp_fma + lerp_fma) * n
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


# ---------------------------------------------------------------------------
# Phase 3: the main path.
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
    plain_model = copy.deepcopy(model)
    plain_model.decode_impl = "xla"
    batches = mapping_batches(N_POINTS, 4, dev)
    loss_fn = make_loss(mapping_loss, **MAPPING_HYPER)
    step = make_train_step(loss_fn, "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt_state = masked_adam_init(model)
    lr = 1e-3
    with torch.no_grad():
        plain_first = float(total_loss(loss_fn(plain_model, batches[0], None)))
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
    check(rel <= 1e-5, f"first step loss {losses[0]!r} vs decode_impl='xla' "
          f"{plain_first!r}: relative difference {rel:.3e} > 1e-5")
    median = float(np.median(step_ms))
    report = dict(
        launches=launches, steps=n_steps, loss_first=losses[0], loss_last=losses[-1],
        loss_first_xla=plain_first, loss_first_rel_diff=rel,
        step_ms_median=median, step_ms_p10=float(np.percentile(step_ms, 10)),
        points_per_s=N_POINTS / (median * 1e-3), wall_s_all_steps=wall,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"  losses: first {losses[0]:.6f} (xla model {plain_first:.6f}, rel diff "
        f"{rel:.2e}), last {losses[-1]:.6f}; kernel launches {launches} in "
        f"{n_steps} steps")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from miso_tpu_torch.ops import _build
    from miso_tpu_torch.ops.fused_decode import _library, fused_interp_decode_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    log("phase 1: build")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    _library()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        log(f"  {name}: nvcc {seconds[name]:.1f} s")
        report_log = _build.BUILD_DIR / f"{name}.log"
        if report_log.exists():
            for line in report_log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
    log(f"  build and load: {build_s:.1f} s")

    log("phase 2: kernels against their plain versions")
    errs, times = phase_kernels()

    log("phase 3: main path (mapping train step)")
    main_report = phase_main_path(fused_interp_decode_cuda)

    log("phase 4: report")
    print(card, flush=True)
    print(json.dumps({"card": card, "build_s": build_s, "max_abs_err": errs,
                      "main_path": main_report}), flush=True)
    kernels = [{
        "name": "fused_interp_decode",
        "route": "cuda",
        "source": "miso_tpu_torch/csrc/fused_interp_decode.cu",
        "replaces": "miso_tpu/ops/pallas_decode.py:186",
        "launches": main_report["launches"],
        "max_abs_err": errs["scannet"],
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,
    }]
    tpu_kernels = [
        {"replaces": "miso_tpu/ops/pallas_decode.py:186", "name": "_fused_kernel",
         "status": "ported and checked", "port": "fused_interp_decode"},
        {"replaces": "miso_tpu/ops/pallas_decode.py:107", "name": "_decode_kernel",
         "status": "not ported"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:196", "name": "_interp_kernel",
         "status": "not ported"},
        {"replaces": "miso_tpu/ops/pallas_interp.py:268", "name": "_interp_grad_kernel",
         "status": "not ported"},
    ]
    print(json.dumps({"tpu_kernels": tpu_kernels}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
