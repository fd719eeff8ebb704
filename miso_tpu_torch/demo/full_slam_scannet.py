"""Full RGB-D SLAM and its evaluation (port of ``demo/full_slam_scannet.py``).

    python -m miso_tpu_torch.demo.full_slam_scannet --synthetic [--device cuda]

Runs the System on an RGB-D sequence (a dataset config, or with
``--synthetic`` a simulated sensor orbiting a procedural room), refines the
map over every keyframe (``--final_iters``), then evaluates: the ATE after
Umeyama alignment, and the Chamfer distance and F-score of the final mesh of
the observed field (``--stability_mesh_thresh``) against the ground truth,
after ICP with ``--icp_align``.  Writes the trajectories (KITTI format), the
mesh and ``results.json``.
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

# The synthetic run's grid (0.5 m and 0.1 m cells over its 13 m cube) and the
# decoder's pretraining epochs.
SYNTHETIC_GRID = {"base_cell_size": 0.5, "per_level_scale": 5.0}
PRETRAIN_EPOCHS = 200


def pretrain_decoder_synthetic(mesh_gt, cfg_model, trunc_dist, device, epochs=None):
    """A decoder pretrained on the scene and kept (the SLAM configs assume a
    pretrained, fixed decoder): trained with a grid over the config's bound
    on the scene's SDF samples for ``epochs`` (``PRETRAIN_EPOCHS``), a third
    of them a level, from a generator seeded 7.  Returns ((W, b), ...)."""
    epochs = PRETRAIN_EPOCHS if epochs is None else epochs
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.train.trainer import GridTrainer

    ds = Sdf3D(mesh_gt, batch_size=2 ** 13, total_samples=2 ** 16, trunc_dist=trunc_dist)
    cfg = copy.deepcopy(cfg_model)
    cfg["decoder"].update({"fix": False, "pretrained_model": None})
    cfg["pose"] = {"optimize": False, "num_poses": 1}
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(7), device=device)
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=trunc_dist)
    GridTrainer({"optimizer": "adam", "learning_rate": 5e-3, "epochs": epochs,
                 "max_epochs_in_level": epochs // 3,
                 "grid_training_mode": "coordinate+joint"}, model, loss_fn, ds).train()
    return tuple((W.detach(), b.detach()) for W, b in model.decoder_params)


def world_trajectory(atlas, n):
    """(n, 4, 4): the first n keyframes' corrected world poses."""
    Rk, tk = (v.detach().cpu().numpy() for v in atlas.params.updated_kf_poses_in_world())
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = Rk[:n], tk[:n]
    return T


def true_trajectory(dataset, n):
    """(n, 4, 4): the first n keyframes' true world poses."""
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        Rg, tg = dataset.true_kf_pose_in_world(k)
        T[k, :3, :3], T[k, :3, 3] = Rg, np.reshape(tg, 3)
    return T


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/rgbd/scannet.yaml")
    p.add_argument("--save_dir", default="./results/torch/full_slam_scannet")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_frames", type=int, default=24)
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--gt_mesh", default=None)
    p.add_argument("--icp_align", action="store_true",
                   help="ICP-align the mesh to the ground truth before the metrics "
                        "(real data whose ground-truth mesh is in another frame)")
    p.add_argument("--stability_mesh_thresh", type=float, default=0.2)
    p.add_argument("--final_iters", type=int, default=200,
                   help="mapping refinement over every keyframe after the run "
                        "(poses locked); 0 disables")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from miso_tpu_torch.config import cfg_dataset, load_config
    from miso_tpu_torch.datasets.lidar import write_kitti_format_poses
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System
    from miso_tpu_torch.utils.eval import (icp_point_to_point, mesh_reconstruction_metrics,
                                           trajectory_error)
    from miso_tpu_torch.utils.sdf import observed_sdf_query, save_mesh

    device = run_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = load_config(repo_path(args.config))
    cfg["system"]["log_dir"] = args.save_dir
    gt_mesh = None
    if args.synthetic:
        from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
        from miso_tpu_torch.datasets.shapes import room_scene
        from miso_tpu_torch.native import TriangleMesh

        gt_mesh = TriangleMesh(*room_scene(5.0, seed=0))
        R, t = orbit_trajectory([0, 0, 0], 1.8, 1.4, args.num_frames, look_at=[0, 0, -0.5])
        dataset = SdfSequence(gt_mesh, R, t, frame_samples=2 ** 13, frame_batchsize=4096,
                              trunc_dist=0.3, near_surface_std=0.1, odom_std_rad=0.002,
                              odom_std_meter=0.005)
        # The submap frame is the first camera's, so the bound is a cube that
        # holds the room from there, whatever the rotation.
        bound = [[-6.5, 6.5], [-6.5, 6.5], [-6.5, 6.5]]
        cfg["system"].update({"submap_size": 100, "submap_local_bound": bound})
        cfg["model"]["grid"].update(dict(SYNTHETIC_GRID, bound=bound))
        cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None,
                                        "hidden_dim": 32})
        cfg["model"]["pose"]["num_poses"] = 100
        cfg["mapping"].update({"trunc_dist": 0.3, "finite_diff_eps": 0.05,
                               "eik_trunc_dist": 0.3, "weight_fs": 0.2, "learning_rate": 3e-3,
                               "use_stability": True})
        cfg["tracking"].update({"solver": "adam", "loss_type": "L1", "learning_rate": 1e-3,
                                "trunc_dist": None})
        cfg["visualizer"] = {"enable": False}
    else:
        dataset = cfg_dataset(cfg)
        if args.gt_mesh:
            from miso_tpu_torch.datasets.sdf_3d import as_mesh
            gt_mesh = as_mesh(args.gt_mesh)

    decoder = None
    if args.synthetic:
        decoder = pretrain_decoder_synthetic(gt_mesh, cfg["model"], 0.3, device)
        cfg["model"]["decoder"]["fix"] = True
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"), device=device)
    if decoder is not None:
        atlas.set_decoder(decoder, fixed=True)
    R0, t0 = dataset.noisy_kf_pose_in_world(0)
    t_start = time.time()
    system = System(atlas, dataset, dataset, cfg, R_world_origin=R0, t_world_origin=t0)
    system.run()
    slam_time = time.time() - t_start

    if args.final_iters > 0:
        # One mapping burst over every keyframe on the settled trajectory.
        system.mapper.mapping(list(range(dataset.num_kfs)), iterations=args.final_iters,
                              level_iterations=max(args.final_iters // 3, 1))
        system.tracker.grid = system.mapper.grid
        system._sync_submap_from_tracker_mapper()

    n = dataset.num_kfs
    T_est, T_gt = world_trajectory(atlas, n), true_trajectory(dataset, n)
    ate = trajectory_error(T_est, T_gt, align=True)
    write_kitti_format_poses(os.path.join(args.save_dir, "traj_est_kitti.txt"), T_est)
    write_kitti_format_poses(os.path.join(args.save_dir, "traj_gt_kitti.txt"), T_gt)

    # The mesh of the observed field: unobserved space decodes far outside.
    mesh = save_mesh(observed_sdf_query(atlas.params, args.stability_mesh_thresh),
                     atlas.global_bound(), os.path.join(args.save_dir, "mesh_final.ply"),
                     resolution=args.mesh_resolution)
    results = {"ate": ate, "slam_time_sec": slam_time, "num_submaps": atlas.num_submaps,
               "num_keyframes": n}
    if gt_mesh is not None and len(mesh.triangles) == 0:
        print("the mesh is empty: no reconstruction metrics")
        results["reconstruction"] = None
    elif gt_mesh is not None:
        eval_mesh = mesh
        if args.icp_align:
            from miso_tpu_torch.native import TriangleMesh

            T_icp, _, _ = icp_point_to_point(mesh.sample_surface(50000, seed=0),
                                             gt_mesh.sample_surface(50000, seed=1),
                                             max_corr_dist=0.5)
            eval_mesh = TriangleMesh(mesh.vertices @ T_icp[:3, :3].T.astype(np.float32)
                                     + T_icp[:3, 3].astype(np.float32), mesh.triangles)
        recon = mesh_reconstruction_metrics(eval_mesh, gt_mesh, n_points=100000,
                                            threshold=0.05, truncation=0.5)
        results["reconstruction"] = recon
        print(json.dumps(recon, indent=2))
    print(f"ATE rmse: {ate['ate_rmse'] * 100:.2f} cm | slam {slam_time:.1f}s")
    with open(os.path.join(args.save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
