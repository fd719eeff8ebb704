"""Multi-submap mapping with known poses (port of ``demo/build_submaps.py``).

    python -m miso_tpu_torch.demo.build_submaps --synthetic [--device cuda]

Dry-runs the SLAM System with tracking and mapping disabled to build the
submap and keyframe structure, then maps each submap on its own with a
coarse-to-fine ``Mapper`` burst of ``--iters`` iterations, meshes each
submap (128^3) and the atlas (``--mesh_resolution``^3), and saves the atlas
(``grid_atlas.npz``, in the JAX package's key spelling, with the structure in
its meta), the run's config beside it (``config.yaml``, which
``align_submaps --atlas`` reads) and ``results.json``.  ``--synthetic`` runs on a procedural room
with a simulated sensor; with real data, point ``--config`` at a dataset
config.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

from miso_tpu_torch.demo import repo_path, run_device


def synthetic_setup(cfg):
    """The demo's synthetic scene, sequence and config overrides: a 24-frame
    orbit in ``room_scene(5.0)``, submaps of 8 keyframes over a 7 x 7 x 4 m
    bound, 1 m / 0.25 m cells and a 32-wide decoder trained with the grids.
    Returns (the ground-truth mesh, the sequence)."""
    from miso_tpu_torch.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh

    mesh_gt = TriangleMesh(*room_scene(5.0, seed=0))
    R, t = orbit_trajectory([0, 0, 0], 1.8, 1.4, 24, look_at=[0, 0, -0.5])
    dataset = SdfSequence(mesh_gt, R, t, frame_samples=2 ** 12, frame_batchsize=2048,
                          trunc_dist=0.3, near_surface_std=0.1)
    bound = [[-3.5, 3.5], [-3.5, 3.5], [-2.0, 2.0]]
    cfg["system"].update({"submap_size": 8, "submap_local_bound": bound})
    cfg["model"]["grid"].update({"base_cell_size": 1.0, "per_level_scale": 4.0,
                                 "bound": bound})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None, "hidden_dim": 32})
    cfg["mapping"].update({"trunc_dist": 0.3, "finite_diff_eps": 0.05, "eik_trunc_dist": 0.3,
                           "weight_fs": 0.2, "learning_rate": 3e-3})
    cfg["model"]["pose"]["num_poses"] = 8
    return mesh_gt, dataset


def dry_run(cfg, dataset, device):
    """The structure-only System run (tracking and mapping disabled): the
    atlas with every submap and keyframe placed."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.slam.system import System

    cfg_dry = copy.deepcopy(cfg)
    cfg_dry["tracking"]["disable"] = True
    cfg_dry["mapping"]["disable"] = True
    cfg_dry["visualizer"] = {"enable": False}
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"), device=device)
    R0, t0 = dataset.noisy_kf_pose_in_world(0)
    System(atlas, dataset, dataset, cfg_dry, R_world_origin=R0, t_world_origin=t0,
           verbose=False).run()
    return atlas


def structure(atlas):
    """The atlas's submap and keyframe structure, as the meta of its file."""
    return {"num_submaps": atlas.num_submaps, "num_keyframes": atlas.num_keyframes,
            "anchor_kfs": [atlas.anchor_kf_for_submap(s) for s in range(atlas.num_submaps)],
            "kf_to_submap": [atlas.submap_id_for_kf(k) for k in range(atlas.num_keyframes)]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/rgbd/scannet.yaml")
    p.add_argument("--save_dir", default="./results/torch/build_submaps")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--iters_per_level", type=int, default=50)
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from miso_tpu_torch.config import cfg_dataset, load_config, save_config
    from miso_tpu_torch.slam.mapper import Mapper
    from miso_tpu_torch.train.checkpoint import save_pytree
    from miso_tpu_torch.utils.sdf import save_mesh

    device = run_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = load_config(repo_path(args.config))
    if args.synthetic:
        _, dataset = synthetic_setup(cfg)
    else:
        dataset = cfg_dataset(cfg)

    # Phase 1: the structure-only dry run.
    atlas = dry_run(cfg, dataset, device)
    print(f"Built structure: {atlas.num_submaps} submaps, {atlas.num_keyframes} keyframes")

    # Phase 2: each submap mapped with the known poses.
    t_start = time.time()
    for s in range(atlas.num_submaps):
        kfs = [k for k in range(atlas.num_keyframes) if atlas.submap_id_for_kf(k) == s]
        mapper = Mapper(atlas.get_submap(s), dataset, cfg)
        mapper.mapping(kfs, iterations=args.iters, level_iterations=args.iters_per_level)
        atlas.set_submap(s, mapper.grid)
        sub = atlas.get_submap(s)
        save_mesh(sub, sub.bound, os.path.join(args.save_dir, f"submap{s}", "mesh_submap.ply"),
                  resolution=128)
        print(f"submap {s}: mapped {len(kfs)} KFs")
    elapsed = time.time() - t_start

    # The global mesh and the atlas's file.
    save_mesh(atlas.params, atlas.global_bound(), os.path.join(args.save_dir, "mesh_final.ply"),
              resolution=args.mesh_resolution)
    save_pytree(os.path.join(args.save_dir, "grid_atlas.npz"), atlas.params,
                meta=structure(atlas))
    save_config(cfg, os.path.join(args.save_dir, "config.yaml"))
    results = {"num_submaps": atlas.num_submaps, "num_keyframes": atlas.num_keyframes,
               "mapping_time_sec": elapsed}
    with open(os.path.join(args.save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"Saved atlas + meshes to {args.save_dir} (mapping {elapsed:.1f}s)")
    return results


if __name__ == "__main__":
    main()
