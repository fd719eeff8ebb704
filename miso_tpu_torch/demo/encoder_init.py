"""Learned initialization against the zero initialization (port of
``demo/encoder_init.py``).

    python -m miso_tpu_torch.demo.encoder_init [--device cuda]

Pretrains a shared decoder on a training room, then per-level feature
encoders on three noisy posed training rooms; on an unseen room it compares
the map from the encoder's one-shot prediction with the zero init, each
followed by K optimization epochs (``--eval_epochs``): the SDF MAE after
each, and the one-shot encoder time, into ``results.json``.  Everything is
synthetic; the draws come from ``--seed``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from miso_tpu_torch.demo import run_device


def model_config():
    """The demo's model: 2 levels of F = 4, 1.0 m base cells, scale 4, an
    8 -> 32 -> 32 -> 1 decoder, 32 pose rows; the bound is each scene's."""
    return {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0, "bound": None,
                 "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                    "pos_invariant": True, "fix": False, "pretrained_model": None},
        "pose": {"optimize": False, "num_poses": 32},
    }


def fixed_decoder_grid(model_cfg, bound, decoder, R, t, generator, device):
    """A GridNet over ``bound`` with ``decoder`` copied in and fixed and its
    keyframe poses set to (R, t)."""
    from miso_tpu_torch.models.grid_net import create_grid_net

    g = create_grid_net(model_cfg, bound=bound, generator=generator, device=device)
    with torch.no_grad():
        for p, v in zip(g.decoder, (t_ for pair in decoder for t_ in pair)):
            p.copy_(v)
        g.Rwk.copy_(torch.as_tensor(np.asarray(R), device=device))
        g.twk.copy_(torch.as_tensor(np.asarray(t), device=device))
    g.decoder_fixed = True
    return g


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save_dir", default="./results/torch/encoder_init")
    p.add_argument("--pretrain_epochs", type=int, default=250)
    p.add_argument("--encoder_epochs", type=int, default=250)
    p.add_argument("--eval_epochs", type=int, nargs="*", default=[0, 5, 15, 50])
    p.add_argument("--trunc_dist", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from miso_tpu_torch.datasets.sdf_3d import PosedSdf3D, Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.demo.full_slam_scannet import pretrain_decoder_synthetic
    from miso_tpu_torch.models.encoder import Encoder, EncoderObservation
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.ops import se3
    from miso_tpu_torch.train.local_opt import initialize_grid_net, optimize_grid_net
    from miso_tpu_torch.training.train_encoders import pretrain_encoders

    device = run_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    td = args.trunc_dist
    model_cfg = model_config()
    gen = torch.Generator().manual_seed(args.seed)
    train_meshes = [TriangleMesh(*room_scene(4.0 + i, seed=args.seed + 1 + i))
                    for i in range(3)]

    print("[1/4] pretraining shared decoder ...")
    v = train_meshes[0].vertices      # Sdf3D's bound: the mesh's box and 0.5 m
    cfg0 = copy.deepcopy(model_cfg)
    cfg0["grid"]["bound"] = np.stack([v.min(0) - 0.5, v.max(0) + 0.5], axis=1).tolist()
    decoder = pretrain_decoder_synthetic(train_meshes[0], cfg0, td, device,
                                         epochs=args.pretrain_epochs)
    model_cfg["decoder"]["fix"] = True

    print("[2/4] pretraining per-level feature encoders ...")
    datasets, grids = [], []
    for i, mesh in enumerate(train_meshes):
        ds = PosedSdf3D(mesh, frame_batchsize=2 ** 10, frame_samples=2 ** 11, num_frames=32,
                        trunc_dist=td, frame_std_rad=0.00872665, frame_std_meter=0.005,
                        distance_std=0.01, seed=i)
        datasets.append(ds)
        grids.append(fixed_decoder_grid(model_cfg, ds.get_inflated_bound(), decoder,
                                        ds.R_world_frame, ds.t_world_frame, gen, device))
    encoder = Encoder({"model": model_cfg}, generator=gen, trunc_dist=td, device=device)
    losses = pretrain_encoders(encoder.level_params, grids, datasets, args.encoder_epochs,
                               trunc_dist=td, pred_std=1e-3, learning_rate=1e-3,
                               seed=args.seed)
    for level, curve in enumerate(losses):
        print(f"  level {level}: final pretrain loss {curve[-1]:.3e}")

    print("[3/4] building unseen test scene ...")
    test_mesh = TriangleMesh(*room_scene(5.0, seed=args.seed))
    ds_obs = PosedSdf3D(test_mesh, frame_batchsize=2 ** 10, frame_samples=2 ** 11,
                        num_frames=32, trunc_dist=td, seed=args.seed + 50)
    ds_eval = Sdf3D(test_mesh, batch_size=2 ** 14, total_samples=2 ** 16, trunc_dist=td)
    grid = fixed_decoder_grid(model_cfg, ds_obs.get_inflated_bound(), decoder,
                              ds_obs.R_world_frame, ds_obs.t_world_frame, gen, device)
    # The observations in world coordinates, as the encoder takes them.
    b = ds_obs.sample(np.random.default_rng(args.seed + 7))
    with torch.no_grad():
        coords_w = se3.transform_points_by_id(
            torch.as_tensor(b["coords_frame"], device=device),
            torch.as_tensor(b["sample_frame_ids"], device=device).reshape(-1).long(),
            torch.as_tensor(ds_obs.R_world_frame, device=device),
            torch.as_tensor(ds_obs.t_world_frame, device=device))
    obs = EncoderObservation(coords_world=coords_w,
                             gt_sdf=torch.as_tensor(b["sdf"], device=device),
                             gt_sdf_sign=torch.as_tensor(b["sdf_signs"], device=device),
                             gt_sdf_valid=torch.as_tensor(b["sdf_valid"], device=device))
    eb = ds_eval.sample(np.random.default_rng(args.seed + 13))
    ex = torch.as_tensor(eb["coords"], device=device)
    ey = eb["sdf"].reshape(-1)
    ev = eb["sdf_valid"].reshape(-1) > 0

    def sdf_mae(g):
        with torch.no_grad():
            pred = g(ex).reshape(-1).cpu().numpy()
        return float(np.abs(pred - ey)[ev].mean())

    print("[4/4] comparing zero-init vs encoder-init convergence ...")
    cfg_opt = {"loss": {"trunc_distance": td, "trunc_weight": 1.0},
               "train": {"optimizer": "adam", "verbose": False}}
    # A first prediction warms every path, so the timed one is the steady state.
    initialize_grid_net(copy.deepcopy(grid), "encode", encoder, obs)
    encoder.grids.clear()
    results = {}
    for mode in ("zero", "encode"):
        g0, info = initialize_grid_net(copy.deepcopy(grid), mode,
                                       encoder if mode == "encode" else None,
                                       obs if mode == "encode" else None)
        encoder.grids.clear()
        curve = {}
        for K in args.eval_epochs:
            gK = g0
            if K:
                gK, _ = optimize_grid_net(copy.deepcopy(g0), ds_obs, cfg_opt, iterations=K,
                                          learning_rate=1e-3, train_mode="joint",
                                          iterations_per_level=max(K // 3, 1), seed=args.seed)
            curve[K] = sdf_mae(gK)
        results[mode] = {"mae_by_epoch": curve, "encoder_time_sec": info["total_encoder_time"]}
        print(f"  {mode:6s}: " + "  ".join(f"K={k}: mae={v:.4f}" for k, v in curve.items())
              + (f"  (encode {info['total_encoder_time'] * 1e3:.0f} ms)"
                 if mode == "encode" else ""))
    with open(os.path.join(args.save_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    z, e = results["zero"]["mae_by_epoch"], results["encode"]["mae_by_epoch"]
    k0 = args.eval_epochs[0]
    print(f"encoder one-shot init MAE {e[k0]:.4f} vs zero-init {z[k0]:.4f}; see results.json")
    return results


if __name__ == "__main__":
    main()
