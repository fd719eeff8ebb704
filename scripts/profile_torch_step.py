#!/usr/bin/env python3
"""Where the port's steps spend their device time, on one CUDA card.

    python3 scripts/profile_torch_step.py [mapping|mesh|slam|all] [--steps N] [--root DIR]

``mapping`` (the default): chip_smoke.py's main path, bench.py's mapping
step (ScanNet widths, 1e6-point batches, masked Adam), first with
decoder.impl "pallas" (the fused kernel), then with GridNet's default decode
(decoder.impl "xla": the interp, interp grad and decode kernels), as bench.py
and configs/ run it: each 3 warm-up steps, N steps unprofiled (default 5),
then N steps under torch.profiler (CPU and CUDA activity).  ``--root``
(default: this checkout) is the checkout whose package is profiled, with this
checkout's chip_smoke, so that another commit unpacked beside this one runs
the same steps in the same call.

``mesh``: chip_smoke.py's synthetic mesh path (room_scene, Sdf3D with 2^15
points per batch, GridTrainer with tsdf_loss_3d and the autograd eikonal,
default decode): 20 warm-up epochs, 20 unprofiled, 20 profiled; then the
192^3 lattice of extract_fields once unprofiled and once profiled.

``slam``: chip_smoke.py's online SLAM of one submap (phase 5's sequence,
config and pretrained decoder): after the init burst and 2 warm-up frames, N
whole frames (odometry, Adam tracking, mapping burst), then the tracking of
one frame and one mapping burst apart, N times each, then LM tracking of one
frame with configs/lidar/ncd_quad.yaml's settings, N times.

For each window it prints the card, the wall time per step (host clock,
synchronised) unprofiled and profiled, the device time per step summed over
kernels and copies, the idle share (device time against the unprofiled
window), the kernels by device time with their share, and the aten
operators by the device time of the kernels they launched.  Imports torch,
numpy, chip_smoke and miso_tpu_torch.
"""
import argparse
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = 25


def breakdown(label, run, steps):
    """Time ``run(steps)`` unprofiled, then profiled, and print the kernel and
    operator tables per step."""
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = per_name[e.name]
            rec[0] += e.time_range.elapsed_us() / 1e3 / steps
            rec[1] += 1
    device_ms = sum(v[0] for v in per_name.values())
    print(f"== {label}: {steps} steps; wall {plain_wall_ms:.3f} ms/step unprofiled, "
          f"{wall_ms:.3f} profiled (host clock); device {device_ms:.3f} ms/step "
          f"summed over kernels; idle share "
          f"{max(0.0, 1.0 - device_ms / plain_wall_ms):.3f} of the unprofiled window")
    print(f"{'ms/step':>9} {'share':>6} {'calls/step':>10}  kernel")
    for name, (ms, calls) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{ms:9.4f} {ms / device_ms:6.3f} {calls / steps:10.1f}  {name[:110]}")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print(f"{'ms/step':>9} {'calls/step':>10}  operator (self device time)")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"{e.self_device_time_total / 1e3 / steps:9.4f} {e.count / steps:10.1f}  "
              f"{e.key}")


def profile_mapping(chip_smoke, impl, steps):
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    cfg = dict(chip_smoke.SCANNET_MODEL,
               decoder=dict(chip_smoke.SCANNET_MODEL["decoder"], impl=impl))
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    batches = chip_smoke.mapping_batches(chip_smoke.N_POINTS, 4, dev)
    step = make_train_step(make_loss(mapping_loss, **chip_smoke.MAPPING_HYPER), "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    state = {"opt": masked_adam_init(model)}

    def run(n):
        for i in range(n):
            _, state["opt"], _, _ = step(model, state["opt"], batches[i % 4], None,
                                         mask, 1e-3)

    run(3)
    torch.cuda.synchronize()
    breakdown(f"mapping train step (decoder.impl {impl!r}, 1e6 points)", run, steps)


def profile_mesh(chip_smoke):
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.trainer import GridTrainer
    from miso_tpu_torch.utils.sdf import extract_fields

    ds = Sdf3D(TriangleMesh(*room_scene(4.0)), batch_size=chip_smoke.MESH_BATCH,
               total_samples=chip_smoke.MESH_SAMPLES, trunc_dist=0.3)
    model = create_grid_net(chip_smoke.mesh_model_cfg(ds.bound.tolist()),
                            generator=torch.Generator().manual_seed(0),
                            device=torch.device("cuda"))
    trainer = GridTrainer(chip_smoke.MESH_TRAIN, model,
                          make_loss(tsdf_loss_3d, **chip_smoke.MESH_LOSS), ds)
    state = {"epoch": 0}

    def run(n):
        for _ in range(n):
            trainer.pre_epoch(state["epoch"])
            trainer.train_epoch(state["epoch"])
            state["epoch"] += 1

    run(20)
    torch.cuda.synchronize()
    breakdown("mesh-path train step (default decode, 2^15 points + 2^15 eikonal)",
              run, 20)

    def lattice(n):
        for _ in range(n):
            extract_fields(model, ds.bound, chip_smoke.MESH_RESOLUTION)

    lattice(1)
    breakdown("extract_fields, 192^3 lattice (one call per step)", lattice, 1)


def profile_slam(chip_smoke, steps):
    import tempfile

    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.slam.submap_slam import SubmapSlam, replay_window
    from miso_tpu_torch.slam.tracker import Tracker
    from miso_tpu_torch.train.checkpoint import save_pytree

    dev = torch.device("cuda")
    mesh, ds = chip_smoke.slam_sequence()
    cfg = chip_smoke.slam_config()
    cfg["system"]["profile"] = False
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decoder.npz")
        save_pytree(path, chip_smoke.pretrain_decoder(mesh, cfg["model"], dev))
        cfg["model"]["decoder"].update({"fix": True, "pretrained_model": path})
        grid = create_grid_net(cfg["model"], bound=cfg["system"]["submap_local_bound"],
                               num_poses=cfg["system"]["submap_size"],
                               generator=torch.Generator().manual_seed(0), device=dev)
    if 2 + 2 * steps >= ds.num_kfs:
        raise ValueError(f"--steps {steps}: the sequence has {ds.num_kfs} frames")
    slam = SubmapSlam(grid, ds, ds, cfg, *ds.noisy_kf_pose_in_world(0))

    def frames(n):
        for _ in range(n):
            slam.step()

    def track(n):
        for _ in range(n):
            slam.tracker.track(slam.curr_kf)

    def mapping(n):
        kfs = replay_window(0, slam.curr_kf, slam.max_replay_frames, slam.max_replay_freq)
        for _ in range(n):
            slam.mapper.mapping(kfs, iterations=slam.map_iters,
                                level_iterations=slam.map_level_iters)

    lidar = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
    lm_tracker = Tracker(slam.grid, ds, {"tracking": lidar["tracking"]})

    def lm(n):
        for _ in range(n):
            lm_tracker.track_lm(slam.curr_kf)

    frames(2)
    torch.cuda.synchronize()
    breakdown("one SLAM frame (odometry, Adam tracking: 15 steps of 4096 points, "
              "mapping burst: 15 steps of 11 x 4096)", frames, steps)
    breakdown("Adam tracking of one frame (15 steps of 4096 points)", track, steps)
    breakdown("one mapping burst (15 steps of 11 x 4096 points)", mapping, steps)
    lm(2)
    breakdown("LM tracking of one frame (10 iterations of 4096 points)", lm, steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="mapping",
                    choices=("mapping", "mesh", "slam", "all"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    which = args.which

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    if which in ("mapping", "all"):
        for impl in ("pallas", "xla"):
            profile_mapping(chip_smoke, impl, args.steps)
    if which in ("mesh", "all"):
        profile_mesh(chip_smoke)
    if which in ("slam", "all"):
        profile_slam(chip_smoke, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
