"""Submap alignment benchmark (port of ``demo/align_submaps.py``).

    python -m miso_tpu_torch.demo.align_submaps [--atlas DIR/grid_atlas.npz]
        [--method miso|vfpp|mips|icp] [--use_sdf] [--device cuda]

Takes an atlas, perturbs every submap's pose but the first (``--noise_deg``
about a random axis, ``--noise_m`` along a random direction), runs the
chosen alignment (MISO's hierarchical latent alignment over
``--feature_levels``, then with ``--use_sdf`` its SDF finetune; the vfpp,
mips or ICP baseline) and writes the submap poses' rotation and translation
RMSE before and after, and the seconds, to ``results.json``.

The atlas is the demo's synthetic one by default (``build_synthetic_atlas``:
two overlapping submaps trained on a room's samples with one fixed
pretrained decoder; the truth is each submap's centre), or with ``--atlas``
one that ``build_submaps`` saved (read under the ``config.yaml`` beside it;
the truth is the poses it was saved with).  vfpp and
mips read raw SDF observations, which only the synthetic atlas carries.
``--save_animation`` renders each iteration's poses through
``utils/atlas_vis.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from miso_tpu_torch.demo import run_device


def build_synthetic_atlas(device, seed=0, n_submaps=2, epochs=250):
    """The demo's synthetic atlas: ``room_scene(6.0)`` with a box and an
    icosphere in the middle, an 8 -> 32 -> 1 decoder pretrained with a grid
    on the whole scene and fixed, then ``n_submaps`` submaps (local bound 6 x
    6 x 3.6 m, 0.75 m / 0.15 m cells, F = 4) centred 3 m apart along x, each
    trained on the scene's samples in its own frame.  Returns (atlas, the
    true submap poses (R (S, 3, 3), t (S, 3)), ``observations(s, rng,
    n=8192)``: the first n of a scene batch's samples inside submap s's
    bound, in its frame, as (coords, sdf, valid))."""
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import box, icosphere, merge_meshes, room_scene
    from miso_tpu_torch.losses.miso import make_loss
    from miso_tpu_torch.losses.sdf import tsdf_loss_3d
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.models.grid_net import create_grid_net
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.train.trainer import GridTrainer

    mesh = TriangleMesh(*merge_meshes(room_scene(6.0, seed=seed),
                                      box(size=(0.9, 0.7, 1.1), center=(0.0, 0.8, -0.4)),
                                      icosphere(2, 0.45, center=(0.2, -1.0, 0.0))))
    centers = [np.array([-1.5 + 3.0 * s, 0, 0], np.float32) for s in range(n_submaps)]
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

    R = np.tile(np.eye(3, dtype=np.float32), (n_submaps, 1, 1))
    return atlas, (R, np.stack(centers)), observations


def load_atlas(path: str, cfg, device):
    """An atlas saved with ``save_pytree`` (``build_submaps``'
    ``grid_atlas.npz``, of either package) under the run's config ``cfg``:
    its submaps and keyframes replayed from the file's structure (meta) and
    bounds, so that the storage takes the saved shapes, then every tensor
    loaded over it."""
    from miso_tpu_torch.models.grid_atlas import GridAtlas
    from miso_tpu_torch.train.checkpoint import load_meta, load_pytree

    meta = load_meta(path)
    with np.load(path, allow_pickle=False) as data:
        bounds, Rws, tws = (data[f"arr::.{k}"] for k in ("bounds", "Rws", "tws"))
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"), device=device)
    for s in range(int(meta["num_submaps"])):
        atlas.add_submap(bounds[s], Rws[s], tws[s])
        for _ in range(meta["kf_to_submap"].count(s)):
            atlas.add_kf()
    load_pytree(path, like=atlas.params)
    return atlas


def perturb(atlas, noise_deg, noise_m, seed):
    """Every submap but 0 moved by ``noise_deg`` about a random axis and
    ``noise_m`` along a random direction (numpy ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    for s in range(1, atlas.num_submaps):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        dr = axis * np.radians(noise_deg)
        dt = rng.standard_normal(3)
        dt = dt / np.linalg.norm(dt) * noise_m
        atlas.set_submap_pose_correction(s, dr.astype(np.float32), dt.astype(np.float32))


def pose_errors(atlas, gt_R, gt_t):
    """Rotation RMSE (degrees) and translation RMSE (m) of submaps 1.. against
    the true poses."""
    from miso_tpu_torch.ops import se3

    R, t = atlas.params.updated_submap_poses()
    S = atlas.num_submaps
    rot = float(se3.rotation_rmse_deg(R[1:S], torch.as_tensor(gt_R[1:S], device=R.device)))
    tr = float(torch.sqrt(((t[1:S] - torch.as_tensor(gt_t[1:S], device=t.device)) ** 2)
                          .sum(-1).mean()))
    return rot, tr


def iteration_frames(align_info):
    """The (S, 4, 4) submap poses of every saved iteration, the stages of a
    hierarchical alignment one after another."""
    if "iteration_results" in align_info:
        histories = [align_info["iteration_results"]]
    else:
        histories = [v["iteration_results"] for v in align_info.values()
                     if isinstance(v, dict) and v.get("iteration_results")]
    return [T for h in histories for _, T in sorted(h.items())]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--atlas", default=None, help="grid_atlas.npz from build_submaps")
    p.add_argument("--save_dir", default="./results/torch/align_submaps")
    p.add_argument("--method", default="miso", choices=["miso", "vfpp", "mips", "icp"])
    p.add_argument("--feature_levels", type=int, nargs="*", default=[0, 1])
    p.add_argument("--use_sdf", action="store_true")
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--save_animation", action="store_true",
                   help="dump per-iteration submap poses and rendered PNG frames")
    p.add_argument("--noise_deg", type=float, default=3.0)
    p.add_argument("--noise_m", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from miso_tpu_torch.align.miso import (align_multiple_submaps_hierarchical,
                                           generic_align_multiple_submaps)
    from miso_tpu_torch.config import load_config

    device = run_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    observations = None
    if args.atlas is None:
        atlas, (gt_R, gt_t), observations = build_synthetic_atlas(device, args.seed)
    else:
        if args.method in ("vfpp", "mips"):
            raise SystemExit(f"--method {args.method} reads the synthetic atlas's raw SDF "
                             "observations; an --atlas file carries none (use miso or icp)")
        cfg = load_config(os.path.join(os.path.dirname(args.atlas), "config.yaml"))
        atlas = load_atlas(args.atlas, cfg, device)
        gt_R, gt_t = (v.detach().cpu().numpy() for v in atlas.params.updated_submap_poses())
    perturb(atlas, args.noise_deg, args.noise_m, args.seed)
    rot0, tr0 = pose_errors(atlas, gt_R, gt_t)
    print(f"BEFORE: rot RMSE {rot0:.3f} deg, trans RMSE {tr0:.3f} m")

    t0 = time.time()
    align_info = None
    if args.method == "miso":
        align_info = align_multiple_submaps_hierarchical(
            atlas, level_iters=args.iters, finetune_iters=args.iters, lr=args.lr,
            align_loss="L2", latent_levels=args.feature_levels, skip_finetune=not args.use_sdf,
            verbose=False, seed=args.seed, save_iterations=args.save_animation)
    elif args.method in ("vfpp", "mips"):
        from miso_tpu_torch.align.baselines import pairwise_loss_mips, pairwise_loss_vfpp

        rng = np.random.default_rng(args.seed)
        obs = {}
        for s in range(atlas.num_submaps):
            c, g, v = observations(s, rng)
            obs[s] = tuple(torch.as_tensor(a, device=device) for a in (c, g, v))
        fn = pairwise_loss_vfpp if args.method == "vfpp" else pairwise_loss_mips
        kw = {"trunc_dist": 0.3} if args.method == "vfpp" else {"surf_tol": 0.02}

        def pair_loss(params, s, d, key, ctx):
            return fn(params, atlas, s, d, *ctx[s], key=key, subsample_points=4096, **kw)

        align_info = generic_align_multiple_submaps(
            atlas, pair_loss, num_iters=args.iters, lr=args.lr, seed=args.seed,
            save_iterations=args.save_animation, loss_ctx=obs)
    else:
        from miso_tpu_torch.align.baselines import align_multiple_submaps_icp

        align_multiple_submaps_icp(atlas)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    if args.save_animation:
        if align_info is None:
            print(f"--save_animation: no iteration history for method '{args.method}' "
                  "(not an iterative pose optimizer); skipped.")
        else:
            from miso_tpu_torch.utils.atlas_vis import render_alignment_animation

            render_alignment_animation(atlas, iteration_frames(align_info),
                                       os.path.join(args.save_dir, "animation"))

    rot1, tr1 = pose_errors(atlas, gt_R, gt_t)
    print(f"AFTER ({args.method}): rot RMSE {rot1:.3f} deg, trans RMSE {tr1:.3f} m "
          f"[{elapsed:.1f}s]")
    results = {"method": args.method, "feature_levels": args.feature_levels,
               "use_sdf": args.use_sdf,
               "rot_rmse_deg_before": rot0, "rot_rmse_deg_after": rot1,
               "trans_rmse_m_before": tr0, "trans_rmse_m_after": tr1,
               "align_time_sec": elapsed}
    with open(os.path.join(args.save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
