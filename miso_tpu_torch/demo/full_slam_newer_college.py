"""Full LiDAR SLAM in submaps, their fusion and the fused mesh (port of
``demo/full_slam_newer_college.py``).

    python -m miso_tpu_torch.demo.full_slam_newer_college --synthetic --scene quad
        [--num_frames 60 --submap_size 30] [--init_mode encode] [--device cuda]

Two sequences over the same scans: a sparse surface-only one for LM
tracking (0.6 m voxels) and a dense one for mapping (0.1 m voxels, with
near-surface, free-space and behind-surface samples).  Runs the System;
with more than one submap, the Fuser aligns the submaps and fuses them.
Then the atlas is consolidated into one world grid (checked against the
atlas's field at 2^16 points) and meshed at ``--mesh_resolution``^3 from
its storage cast to bfloat16.  Writes the KITTI trajectory, a final
checkpoint, the mesh and ``results.json``.

``--synthetic`` simulates a LiDAR on a procedural scene: ``--scene quad``, a
40 m walled courtyard toured by a ground robot, each submap covering the
whole site's box; ``--scene room``, an 8 m room orbited by the sensor.
``--init_mode encode`` starts each submap from per-level encoders
pretrained on two held-out scenes of the same family.  The pretrained
decoder and encoders are cached only where ``--decoder_cache`` (a file) and
``--encoder_cache`` (a directory of ``Encoder.save``'s files) name one (the
JAX demo's default caches under /tmp have no counterpart: the port writes
nothing outside the paths it is given).
The JAX demo's compile arguments (``--no_prewarm``, ``--prewarm_only``,
``--jax_cache``) have none either.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from miso_tpu_torch.demo import repo_path, run_device
from miso_tpu_torch.demo.full_slam_scannet import pretrain_decoder_synthetic

# The synthetic run's grid (1 m and 0.2 m cells), the encoders' pretraining
# steps a level, and the Fuser's fuse after the alignment.
SYNTHETIC_GRID = {"base_cell_size": 1.0, "per_level_scale": 5.0}
ENCODER_EPOCHS = 150
FUSE = dict(feat_lr=1e-3, submap_pose_lr=1e-4, kf_pose_lr=1e-4, iterations=30)


def synthetic_scene(scene, num_frames, laps):
    """(mesh, R, t, scan settings, tracking voxels, mapping voxels) of the
    synthetic scene; the quad's scans are a spinning LiDAR's (192 x 64)."""
    from miso_tpu_torch.datasets.sequence import circuit_trajectory, orbit_trajectory
    from miso_tpu_torch.datasets.shapes import quad_scene, room_scene
    from miso_tpu_torch.native import TriangleMesh

    if scene == "quad":
        mesh = TriangleMesh(*quad_scene(40.0, seed=0, path_half_extent=14.0))
        R, t = circuit_trajectory(14.0, 1.5, num_frames, laps=laps, wobble=0.3)
        return (mesh, R, t, dict(scan_pattern="lidar", width=192, height=64),
                dict(voxel_size=0.6), dict(voxel_size=0.1))
    mesh = TriangleMesh(*room_scene(8.0, seed=0))
    R, t = orbit_trajectory([0, 0, 0], 2.5, 1.6, num_frames, look_at=[0, 0, -0.5])
    return mesh, R, t, {}, {}, {}


def pretrain_encoders_synthetic(decoder, cfg_model, trunc_dist, scene, device, seed=0):
    """Per-level feature encoders pretrained ``ENCODER_EPOCHS`` steps a level
    on two held-out scenes of the run's family (seeds 1 and 2), sharing the
    run's decoder, over one shared bound.  Returns the Encoder."""
    from miso_tpu_torch.datasets.sequence import (SdfSequence, circuit_trajectory,
                                                  orbit_trajectory)
    from miso_tpu_torch.datasets.shapes import quad_scene, room_scene
    from miso_tpu_torch.demo.encoder_init import fixed_decoder_grid
    from miso_tpu_torch.models.encoder import Encoder
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.training.train_encoders import pretrain_encoders

    scenes = []
    for i in range(2):
        if scene == "quad":
            verts, tris = quad_scene(40.0, seed=seed + 1 + i, path_half_extent=14.0)
            R, t = circuit_trajectory(14.0, 1.5, 24, laps=1.0, wobble=0.3)
            kw = dict(scan_pattern="lidar", width=192, height=64, voxel_size=0.15)
        else:
            verts, tris = room_scene(8.0 + i, seed=seed + 1 + i)
            R, t = orbit_trajectory([0, 0, 0], 2.5, 1.6, 24, look_at=[0, 0, -0.5])
            kw = {}
        scenes.append((verts, tris, R, t, kw))
    bound = np.stack([np.min([v.min(0) for v, *_ in scenes], 0) - 1.0,
                      np.max([v.max(0) for v, *_ in scenes], 0) + 1.0], axis=1)
    gen = torch.Generator().manual_seed(seed)
    datasets, grids = [], []
    for i, (verts, tris, R, t, kw) in enumerate(scenes):
        ds = SdfSequence(TriangleMesh(verts, tris), R, t, frame_samples=2 ** 11,
                         frame_batchsize=512, trunc_dist=trunc_dist, near_surface_n=2,
                         near_surface_std=0.25, free_space_n=1, behind_surface_n=1, seed=i,
                         **kw)
        c2 = copy.deepcopy(cfg_model)
        c2["pose"] = {"optimize": False, "num_poses": len(R)}
        datasets.append(ds)
        grids.append(fixed_decoder_grid(c2, bound, decoder, ds.R_gt, ds.t_gt, gen, device))
    encoder = Encoder({"model": cfg_model}, generator=gen, trunc_dist=trunc_dist, device=device)
    losses = pretrain_encoders(encoder.level_params, grids, datasets, ENCODER_EPOCHS,
                               trunc_dist=trunc_dist, pred_std=1e-3, learning_rate=1e-3,
                               seed=seed)
    for level, curve in enumerate(losses):
        print(f"  encoder level {level}: pretrain loss {curve[-1]:.3e}", flush=True)
    return encoder


def mesh_bound(cfg, atlas):
    """The meshing bound: the configured world box (else the atlas's global
    bound) padded by 0.5 m."""
    wb = cfg["system"].get("submap_world_bound")
    b = np.asarray(wb, np.float32) if wb is not None else atlas.global_bound()
    return b + np.array([-0.5, 0.5], np.float32)


def _json_safe(x):
    """Tensors, arrays and numpy scalars in nested dicts as plain values."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/lidar/ncd_quad.yaml")
    p.add_argument("--save_dir", default="./results/torch/full_slam_ncd")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--scene", default="room", choices=["room", "quad"])
    p.add_argument("--laps", type=float, default=1.0)
    p.add_argument("--num_frames", type=int, default=30)
    p.add_argument("--submap_size", type=int, default=None,
                   help="keyframes a submap (synthetic); below --num_frames spawns several "
                        "submaps and runs the Fuser's alignment and fuse after the run")
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--capacity", type=int, default=None,
                   help="preallocated submap slots (system.submap_capacity)")
    p.add_argument("--no_profile", action="store_true",
                   help="disable the per-frame stage profiler")
    p.add_argument("--max_frames", type=int, default=None,
                   help="stop the SLAM loop after this many frames")
    p.add_argument("--init_mode", default="zero", choices=["zero", "encode"],
                   help="submap features at a spawn: 'encode' takes the encoders' one-shot "
                        "prediction and a shorter init burst")
    p.add_argument("--init_iters_encode", type=int, default=None,
                   help="init mapping iterations after an encoder init "
                        "(default init_iterations // 3)")
    p.add_argument("--encoder_cache", default=None,
                   help="a directory to reuse pretrained encoders from (and save them to)")
    p.add_argument("--decoder_cache", default=None,
                   help="a file to reuse the pretrained decoder from (and save it to)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from miso_tpu_torch.config import load_config
    from miso_tpu_torch.datasets.lidar import PosedSdf3DLidar, write_kitti_format_poses
    from miso_tpu_torch.datasets.sequence import SdfSequence
    from miso_tpu_torch.demo.full_slam_scannet import true_trajectory, world_trajectory
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.fuser import Fuser
    from miso_tpu_torch.slam.system import System
    from miso_tpu_torch.train.checkpoint import load_pytree, save_pytree
    from miso_tpu_torch.utils.eval import trajectory_error
    from miso_tpu_torch.utils.sdf import save_mesh

    device = run_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = load_config(repo_path(args.config))
    cfg["system"]["log_dir"] = args.save_dir
    cfg["system"]["profile"] = not args.no_profile
    if args.capacity:
        cfg["system"]["submap_capacity"] = args.capacity

    mesh_gt = v_sys = None
    if args.synthetic:
        mesh_gt, R, t, scan_kw, track_kw, map_kw = synthetic_scene(args.scene, args.num_frames,
                                                                   args.laps)
        if args.scene == "quad":
            # The site box in the system frame (identity rotation at the first
            # pose): every submap's bound covers the whole site.
            t0_ = t[0] + 0.0
            v_sys = (mesh_gt.vertices - t0_) @ R[0] + t0_
            world_bound = np.stack([v_sys.min(0) - 1.0, v_sys.max(0) + 1.0], axis=1)
            bound = (world_bound - world_bound.mean(axis=1, keepdims=True)).tolist()
        else:
            # A cube that holds the whole room seen from the anchor pose.
            bound = [[-9.0, 9.0], [-9.0, 9.0], [-9.0, 9.0]]
        noise = dict(odom_std_rad=0.002, odom_std_meter=0.01)
        ds_track = SdfSequence(mesh_gt, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                               trunc_dist=0.5, surface_only=True, **noise, **scan_kw,
                               **track_kw)
        ds_map = SdfSequence(mesh_gt, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                             trunc_dist=0.5, near_surface_n=2, near_surface_std=0.25,
                             free_space_n=1, behind_surface_n=1, **noise, **scan_kw, **map_kw)
        cfg["system"].update({"submap_size": args.submap_size or 100,
                              "submap_local_bound": bound, "submap_axis_aligned": True})
        if args.scene == "quad":
            cfg["system"]["submap_world_bound"] = world_bound.tolist()
        cfg["model"]["grid"].update(dict(SYNTHETIC_GRID, bound=bound))
        cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None,
                                        "hidden_dim": 32})
        cfg["model"]["pose"]["num_poses"] = max(args.submap_size or 100, 100)
        cfg["mapping"].update({"trunc_dist": 0.5, "finite_diff_eps": 0.1, "eik_trunc_dist": 0.5,
                               "weight_fs": 0.3, "learning_rate": 3e-3, "loss_type": "L2",
                               "iters_per_frame": 15, "level_iters_per_frame": 5,
                               "init_iterations": 100, "mask_bound": 1.0})
        cfg["tracking"].update({"solver": "lm", "loss_type": "GM", "gm_scale_sdf": 0.2,
                                "lm_max_iter": 16, "trunc_dist": 0.5, "lm_tol_deg": 0.005,
                                "lm_tol_m": 0.001})
        cfg["visualizer"] = {"enable": False}
    else:
        d = cfg["dataset"]
        common = dict(lidar_folder=d["path"], pose_file_gt=d["pose_gt"],
                      pose_file_init=d["pose_init"], num_frames=d.get("num_frames"),
                      frame_batchsize=d.get("frame_batchsize", 1024),
                      trunc_dist=d.get("trunc_dist", 0.5))
        ds_track = PosedSdf3DLidar(frame_samples=2 ** 20, voxel_size=0.6, surface_only=True,
                                   **common)
        ds_map = PosedSdf3DLidar(frame_samples=d.get("frame_samples", 2 ** 12), voxel_size=0.08,
                                 near_surface_n=4, free_space_n=2, behind_surface_n=1, **common)

    decoder = None
    if args.synthetic:
        t0 = time.time()
        if args.decoder_cache and os.path.exists(args.decoder_cache):
            decoder = load_pytree(args.decoder_cache, _decoder_like(cfg["model"], device))
            print(f"decoder loaded from {args.decoder_cache}", flush=True)
        else:
            decoder = pretrain_decoder_synthetic(mesh_gt, cfg["model"], 0.5, device)
            if args.decoder_cache:
                save_pytree(args.decoder_cache, decoder)
            print(f"decoder pretrain {time.time() - t0:.1f}s", flush=True)
        cfg["model"]["decoder"]["fix"] = True
    encoder = None
    if args.synthetic and args.init_mode == "encode":
        from miso_tpu_torch.models.encoder import Encoder

        if args.encoder_cache and os.path.isdir(args.encoder_cache):
            encoder = Encoder({"model": cfg["model"]}, pretrained_dir=args.encoder_cache,
                              trunc_dist=0.5, device=device)
            print(f"encoders loaded from {args.encoder_cache}", flush=True)
        else:
            t0 = time.time()
            encoder = pretrain_encoders_synthetic(decoder, cfg["model"], 0.5, args.scene, device)
            if args.encoder_cache:
                encoder.save(args.encoder_cache)
            print(f"encoder pretrain {time.time() - t0:.1f}s", flush=True)
        cfg["system"]["submap_init_mode"] = "encode"
        if args.init_iters_encode:
            cfg["mapping"]["init_iterations_encode"] = args.init_iters_encode
    cfg.setdefault("align", {}).update({"level_iters": 50, "finetune_iters": 50,
                                        "skip_finetune": False, "learning_rate": 2e-3,
                                        "subsample_points": 8192})
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"), device=device)
    if decoder is not None:
        atlas.set_decoder(decoder, fixed=True)
    R0, t0 = ds_track.noisy_kf_pose_in_world(0)
    if args.synthetic:
        # Axis-aligned submaps anchored at the first pose.
        R0 = np.eye(3, dtype=np.float32)
    t_start = time.time()
    system = System(atlas, ds_track, ds_map, cfg, R_world_origin=R0, t_world_origin=t0,
                    encoder=encoder)
    system.run(max_frames=args.max_frames)
    slam_time = time.time() - t_start

    def ate_now():
        n = min(ds_track.num_kfs, atlas.num_keyframes)
        T_est = world_trajectory(atlas, n)
        return trajectory_error(T_est, true_trajectory(ds_track, n), align=True), T_est

    ate_prefusion = ate_postalign = align_info = None
    fusion_time = align_time = fuse_time = None
    fuser = None
    if atlas.num_submaps > 1:
        fuser = Fuser(atlas, ds_map, cfg)
        ate_prefusion = ate_now()[0]
        print(f"{atlas.num_submaps} submaps | pre-fusion ATE "
              f"{ate_prefusion['ate_rmse'] * 100:.2f} cm / "
              f"{ate_prefusion['rot_rmse_deg']:.2f} deg -> Fuser align+fuse")
        t_fuse = time.time()
        align_info = fuser.align()
        align_time = time.time() - t_fuse
        ate_postalign = ate_now()[0]
        print(f"align {align_time:.1f}s -> ATE {ate_postalign['ate_rmse'] * 100:.2f} cm / "
              f"{ate_postalign['rot_rmse_deg']:.2f} deg", flush=True)
        t1 = time.time()
        fuser.fuse(**FUSE)
        fuse_time = time.time() - t1
        fusion_time = time.time() - t_fuse

    ate, T_est = ate_now()
    write_kitti_format_poses(os.path.join(args.save_dir, "traj_est_kitti.txt"), T_est)
    profile = system.profile_summary()
    n_frames = atlas.num_keyframes
    print(f"ATE rmse {ate['ate_rmse'] * 100:.2f} cm / {ate['rot_rmse_deg']:.2f} deg | "
          f"{n_frames} frames, {atlas.num_submaps} submaps | slam {slam_time:.1f}s")
    results = {"ate": ate, "ate_prefusion": ate_prefusion, "ate_postalign": ate_postalign,
               "slam_time_sec": slam_time, "fusion_time_sec": fusion_time,
               "align_time_sec": align_time, "align_stage_info": _json_safe(align_info),
               "fuse_time_sec": fuse_time,
               "fuse_info": _json_safe(getattr(fuser, "last_fuse_info", None)),
               "num_frames": n_frames, "num_submaps": atlas.num_submaps,
               "init_mode": args.init_mode,
               "init_iterations": cfg["mapping"].get("init_iterations"),
               "init_iterations_encode": system.init_iters_encode
               if args.init_mode == "encode" else None,
               "encoder_info": _json_safe(system.encoder_info), "frame_profile": profile}
    res_path = os.path.join(args.save_dir, "results.json")
    with open(res_path, "w") as f:
        json.dump(results, f, indent=2)
    system.save_checkpoint(os.path.join(args.save_dir, "ckpt_final.npz"))

    # Fuse, then mesh: the atlas resampled onto one world grid, checked
    # against the atlas's field at random points, meshed from bf16 storage.
    mb = mesh_bound(cfg, atlas)
    t0 = time.time()
    fused = atlas.consolidated_grid(bound=mb)
    consolidate_time = time.time() - t0
    pts = np.random.default_rng(0).uniform(mb[:, 0], mb[:, 1], size=(2 ** 16, 3))
    x = torch.as_tensor(pts.astype(np.float32), device=device)
    with torch.no_grad():
        dd = (atlas.params(x) - fused(x)).abs().reshape(-1).cpu().numpy()
    cons_err = {"mean_abs": float(dd.mean()), "p99_abs": float(np.quantile(dd, 0.99)),
                "max_abs": float(dd.max())}
    print(f"consolidate {consolidate_time:.1f}s | fused-vs-atlas |dSDF| mean "
          f"{cons_err['mean_abs']:.2e} p99 {cons_err['p99_abs']:.2e} max "
          f"{cons_err['max_abs']:.2e}", flush=True)
    t0 = time.time()
    mesh_out = save_mesh(fused, mb, os.path.join(args.save_dir, "mesh_final.ply"),
                         resolution=args.mesh_resolution, feature_dtype="bfloat16")
    mesh_time = time.time() - t0
    print(f"mesh {args.mesh_resolution}^3 {mesh_time:.1f}s", flush=True)
    mesh_metrics = None
    if args.synthetic and len(mesh_out.triangles):
        # Against the generating scene in the system frame; 10 cm F-score
        # threshold outdoors, 5 cm in the room.
        from miso_tpu_torch.native import TriangleMesh
        from miso_tpu_torch.utils.eval import mesh_reconstruction_metrics

        if args.scene == "quad":
            gt_eval, thresh = TriangleMesh(v_sys.astype(np.float32), mesh_gt.triangles), 0.10
        else:
            gt_eval, thresh = mesh_gt, 0.05
        mesh_metrics = mesh_reconstruction_metrics(mesh_out, gt_eval, n_points=100000,
                                                   threshold=thresh)
        mesh_metrics["threshold_m"] = thresh
        print("mesh vs GT:", {k: round(v, 3) for k, v in mesh_metrics.items()}, flush=True)
    results.update(mesh_resolution=args.mesh_resolution, mesh_time_sec=mesh_time,
                   consolidate_time_sec=consolidate_time, consolidation_sdf_error=cons_err,
                   mesh_vs_gt=mesh_metrics)
    with open(res_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


def _decoder_like(cfg_model, device):
    """A decoder of the config's widths, the structure a cached one loads into."""
    from miso_tpu_torch.models.grid_net import decoder_from_config

    cfg = copy.deepcopy(cfg_model)
    cfg["decoder"].update({"pretrained_model": None})
    return decoder_from_config(cfg, torch.Generator().manual_seed(0), device=device)


if __name__ == "__main__":
    main()
