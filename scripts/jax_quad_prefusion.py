#!/usr/bin/env python3
"""The JAX package's two-submap quad run up to the Fuser, or through it, as a
reference for chip_smoke.py phase 6.

    JAX_PLATFORMS=cpu python3 scripts/jax_quad_prefusion.py [--fuse] [--out FILE]

Runs ``demo/full_slam_newer_college.py --synthetic --scene quad --num_frames
60 --submap_size 30`` through the JAX package (the demo's own setup, decoder
pretrain and System), stops before the Fuser (unless ``--fuse``), and reads
what phase 6 reads:
the pre-fusion ATE and rotation RMSE, the odometry-only trajectory's, the
ATE within the submaps (each submap's keyframes aligned on their own), then
``consolidated_grid`` over the demo's mesh bound, the fused-vs-atlas |dSDF|
at 2^16 points, and the fused grid's 128^3 mesh in float32 with its metrics
at 10 cm against the ground truth in the system frame.  Prints the figures
and writes them as JSON to ``--out`` (default: stdout only).

``--fuse`` runs the demo's Fuser between the pre-fusion readings and the
consolidation (``demo/full_slam_newer_college.py:443-456``, ``:539-565``):
``Fuser.align()`` with the demo's overrides of the config's ``align:`` section
(50 latent and 50 finetune iterations, lr 2e-3, 8192 points a pair), then
``fuse(feat_lr=1e-3, submap_pose_lr=1e-4, kf_pose_lr=1e-4, iterations=30)``,
with the ATE after each and their seconds; consolidation and the mesh then
read the fused atlas.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAMES = 60
SUBMAP_SIZE = 30
MESH_RESOLUTION = 128
THRESH = 0.10


def _demo():
    spec = importlib.util.spec_from_file_location(
        "full_slam_newer_college", os.path.join(ROOT, "demo", "full_slam_newer_college.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, np.reshape(t, 3)
    return T


def _ate_within(T_est, T_gt, sub, trajectory_error):
    per, sq = [], 0.0
    for s in range(int(sub.max()) + 1):
        rmse = trajectory_error(T_est[sub == s], T_gt[sub == s], align=True)["ate_rmse"]
        per.append(float(rmse))
        sq += rmse ** 2 * int((sub == s).sum())
    return dict(ate_rmse=float(np.sqrt(sq / len(sub))), per_submap=per)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--fuse", action="store_true",
                    help="align and fuse the submaps before consolidating")
    args = ap.parse_args()
    import jax.numpy as jnp

    from miso_tpu.config import load_config
    from miso_tpu.datasets.sequence import SdfSequence, circuit_trajectory
    from miso_tpu.datasets.shapes import quad_scene
    from miso_tpu.models.grid_atlas import GridAtlas
    from miso_tpu.native import TriangleMesh
    from miso_tpu.slam.system import System
    from miso_tpu.utils.eval import mesh_reconstruction_metrics, trajectory_error
    from miso_tpu.utils.sdf import save_mesh

    demo = _demo()
    t_all = time.time()
    # demo/full_slam_newer_college.py:266-351 for --synthetic --scene quad.
    verts, tris = quad_scene(40.0, seed=0, path_half_extent=14.0)
    mesh_gt = TriangleMesh(verts, tris)
    R, t = circuit_trajectory(14.0, 1.5, FRAMES, laps=1.0, wobble=0.3)
    scan_kw = dict(scan_pattern="lidar", width=192, height=64)
    t0 = t[0] + 0.0
    v_sys = (verts - t0) @ R[0] + t0
    world_bound = np.stack([v_sys.min(0) - 1.0, v_sys.max(0) + 1.0], axis=1)
    bound = (world_bound - world_bound.mean(axis=1, keepdims=True)).tolist()
    noise = dict(odom_std_rad=0.002, odom_std_meter=0.01)
    ds_track = SdfSequence(mesh_gt, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                           trunc_dist=0.5, surface_only=True, voxel_size=0.6,
                           **noise, **scan_kw)
    ds_map = SdfSequence(mesh_gt, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                         trunc_dist=0.5, near_surface_n=2, near_surface_std=0.25,
                         free_space_n=1, behind_surface_n=1, voxel_size=0.1,
                         **noise, **scan_kw)
    cfg = load_config(os.path.join(ROOT, "configs", "lidar", "ncd_quad.yaml"))
    cfg["system"].update({"submap_size": SUBMAP_SIZE, "submap_local_bound": bound,
                          "submap_axis_aligned": True, "profile": True,
                          "submap_world_bound": world_bound.tolist()})
    cfg["model"]["grid"].update({"base_cell_size": 1.0, "per_level_scale": 5.0,
                                 "bound": bound})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None,
                                    "hidden_dim": 32})
    cfg["model"]["pose"]["num_poses"] = max(SUBMAP_SIZE, 100)
    cfg["mapping"].update({"trunc_dist": 0.5, "finite_diff_eps": 0.1, "eik_trunc_dist": 0.5,
                           "weight_fs": 0.3, "learning_rate": 3e-3, "loss_type": "L2",
                           "iters_per_frame": 15, "level_iters_per_frame": 5,
                           "init_iterations": 100, "mask_bound": 1.0})
    cfg["tracking"].update({"solver": "lm", "loss_type": "GM", "gm_scale_sdf": 0.2,
                            "lm_max_iter": 16, "trunc_dist": 0.5, "lm_tol_deg": 0.005,
                            "lm_tol_m": 0.001})
    cfg["visualizer"] = {"enable": False}

    t1 = time.time()
    dec = demo.pretrain_decoder_synthetic(mesh_gt, cfg["model"], 0.5)
    pretrain_s = time.time() - t1
    cfg["model"]["decoder"]["fix"] = True
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=SUBMAP_SIZE,
                      capacity=cfg["system"].get("submap_capacity"))
    atlas.set_decoder(dec, fixed=True)
    _, t_w0 = ds_track.noisy_kf_pose_in_world(0)
    t1 = time.time()
    system = System(atlas, ds_track, ds_map, cfg, R_world_origin=np.eye(3, dtype=np.float32),
                    t_world_origin=t_w0)
    system.run()
    slam_s = time.time() - t1

    Rk, tk = atlas.params.updated_kf_poses_in_world()
    n = atlas.num_keyframes
    T_est = np.stack([_pose(r, p) for r, p in zip(np.asarray(Rk)[:n], np.asarray(tk)[:n])])
    T_gt = np.stack([_pose(*ds_track.true_kf_pose_in_world(k)) for k in range(n)])
    T_odom = [_pose(*ds_track.noisy_kf_pose_in_world(0))]
    for k in range(n - 1):
        T_odom.append(T_odom[-1] @ ds_track.get_odometry_at_pose(k))
    T_odom = np.stack(T_odom)
    sub = np.array([atlas.submap_id_for_kf(k) for k in range(n)])
    out = dict(frames=n, submaps=atlas.num_submaps, pretrain_s=pretrain_s, slam_s=slam_s,
               ate_prefusion=trajectory_error(T_est, T_gt, align=True),
               ate_odometry_only=trajectory_error(T_odom, T_gt, align=True),
               ate_in_submaps={"slam": _ate_within(T_est, T_gt, sub, trajectory_error),
                               "odom": _ate_within(T_odom, T_gt, sub, trajectory_error)})

    if args.fuse:
        from miso_tpu.slam.fuser import Fuser

        def ate():
            Rk, tk = atlas.params.updated_kf_poses_in_world()
            T = np.stack([_pose(r, p) for r, p in zip(np.asarray(Rk)[:n], np.asarray(tk)[:n])])
            return trajectory_error(T, T_gt, align=True)

        cfg.setdefault("align", {}).update({"level_iters": 50, "finetune_iters": 50,
                                            "skip_finetune": False, "learning_rate": 2e-3,
                                            "subsample_points": 8192})
        fuser = Fuser(atlas, ds_map, cfg)
        t1 = time.time()
        fuser.align()
        align_s = time.time() - t1
        ate_postalign = ate()
        t1 = time.time()
        fuse_loss = fuser.fuse(feat_lr=1e-3, submap_pose_lr=1e-4, kf_pose_lr=1e-4,
                               iterations=30)
        fuse_s = time.time() - t1
        out.update(align_s=align_s, fuse_s=fuse_s, ate_postalign=ate_postalign,
                   ate_postfuse=ate(), fuse_final_loss=fuse_loss,
                   fuse_info=fuser.last_fuse_info)
        print(f"align {align_s:.1f} s -> ATE {100 * ate_postalign['ate_rmse']:.3f} cm; fuse "
              f"{fuse_s:.1f} s -> ATE {100 * out['ate_postfuse']['ate_rmse']:.3f} cm", flush=True)

    mb = demo._mesh_bound(cfg, atlas)
    t1 = time.time()
    fused = atlas.consolidated_grid(bound=mb)
    consolidate_s = time.time() - t1
    pts = np.random.default_rng(0).uniform(mb[:, 0], mb[:, 1],
                                           size=(2 ** 16, 3)).astype(np.float32)
    dd = np.abs(np.asarray(atlas.params(jnp.asarray(pts)))
                - np.asarray(fused(jnp.asarray(pts)))).reshape(-1)
    t1 = time.time()
    mesh = save_mesh(fused, mb, None, resolution=MESH_RESOLUTION)
    mesh_s = time.time() - t1
    gt_sys = TriangleMesh(v_sys.astype(np.float32), tris)
    recon = mesh_reconstruction_metrics(mesh, gt_sys, n_points=100000, threshold=THRESH)
    sd = gt_sys.signed_distance(np.asarray(mesh.vertices, np.float32))
    out.update(consolidate_s=consolidate_s, mesh_s=mesh_s,
               sdf_error=dict(mean_abs=float(dd.mean()), p99_abs=float(np.quantile(dd, 0.99)),
                              max_abs=float(dd.max())),
               mesh=dict(resolution=MESH_RESOLUTION, vertices=int(len(mesh.vertices)),
                         vertex_sdf_median_m=float(np.median(sd)),
                         vertices_within_thresh=float(np.mean(np.abs(sd) < THRESH))),
               reconstruction={k: float(v) for k, v in recon.items()},
               seconds=time.time() - t_all)
    out = json.loads(json.dumps(out, default=float))
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
