#!/usr/bin/env python3
"""The JAX package's ``demo/encoder_init.py`` at its defaults, once per key
of the shared decoder's initial draw, as the reference for chip_smoke.py
phase 8 (a).

    JAX_PLATFORMS=cpu python3 scripts/jax_encoder_init.py [--decoder_keys 7 8 ...]
        [--out FILE] [--export DIR]

The demo draws its decoder from ``jax.random.PRNGKey(7)``; the port draws
its own from a torch generator, so the two decoders differ before training.
A grid with zero features decodes to one constant, the decoder's value at
zero, which training does not pin: the zero init's MAE at K=0 is set by that
draw, and so are its next readings.  This script runs the demo's recipe
(the same scenes, datasets, encoder pretraining, test scene and K = 0, 5,
15, 50 finetunes) with each given decoder key and prints the eight readings
of each run, then a JSON object with them and their mean and standard
deviation over the keys.  Key 7 is the demo's own run.

``--export DIR`` writes the random draws of the first key's run, so the
port can run the demo from them: ``DIR/feature_encoder_level_{l}.npz`` (the
encoders' initial parameters, the JAX package's ``Encoder.save``) and
``DIR/draws.npz`` (the decoder's initial ``W{i}``/``b{i}``; the camera
rotations ``{name}_R_gt``, true positions ``{name}_t_gt`` and noisy poses
``{name}_R``/``{name}_t`` of the three training datasets ``train{i}`` and of
the test scene's ``test``).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EVAL_EPOCHS = (0, 5, 15, 50)


def run(decoder_key, seed=0, td=0.2, pretrain_epochs=250, encoder_epochs=250, export=None):
    """demo/encoder_init.py:main with the decoder drawn from ``decoder_key``;
    returns {mode: {K: MAE}} and the pretrained decoder's value at zero
    features.  ``export``: a directory for the run's random draws."""
    import jax
    import jax.numpy as jnp

    from miso_tpu.datasets.sdf_3d import PosedSdf3D, Sdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.losses.miso import make_loss
    from miso_tpu.losses.sdf import tsdf_loss_3d
    from miso_tpu.models.base import tree_full_mask, tree_zero_mask
    from miso_tpu.models.encoder import (Encoder, EncoderObservation, encoder_pretrain_loss,
                                         feature_prediction_init)
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.native import TriangleMesh
    from miso_tpu.ops import se3
    from miso_tpu.train.local_opt import initialize_grid_net, optimize_grid_net
    from miso_tpu.train.optim import masked_adam_init, masked_adam_update
    from miso_tpu.train.trainer import GridTrainer

    model_cfg = {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 0.0, "bound": None,
                 "base_cell_size": 1.0, "per_level_scale": 4.0, "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 32, "hidden_layers": 1, "out_dim": 1,
                    "pos_invariant": True, "fix": False, "pretrained_model": None},
        "pose": {"optimize": False, "num_poses": 32},
    }
    train_meshes = [TriangleMesh(*room_scene(4.0 + i, seed=seed + 1 + i)) for i in range(3)]
    ds0 = Sdf3D(train_meshes[0], batch_size=2 ** 13, total_samples=2 ** 16, trunc_dist=td)
    cfg0 = {k: (dict(v) if isinstance(v, dict) else v) for k, v in model_cfg.items()}
    cfg0["pose"] = {"optimize": False, "num_poses": 1}
    dec_grid = create_grid_net(jax.random.PRNGKey(decoder_key), cfg0, bound=ds0.bound)
    draws = {f"{w}{i}": np.asarray(a) for i, (W, b) in enumerate(dec_grid.decoder)
             for w, a in (("W", W), ("b", b))}
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=td)
    dec = GridTrainer({"optimizer": "adam", "learning_rate": 5e-3, "epochs": pretrain_epochs,
                       "max_epochs_in_level": pretrain_epochs // 3,
                       "grid_training_mode": "coordinate+joint"},
                      dec_grid, loss_fn, ds0).train().decoder
    model_cfg["decoder"]["fix"] = True

    datasets, grids = [], []
    key = jax.random.PRNGKey(seed)
    for i, mesh in enumerate(train_meshes):
        ds = PosedSdf3D(mesh, frame_batchsize=2 ** 10, frame_samples=2 ** 11, num_frames=32,
                        trunc_dist=td, frame_std_rad=0.00872665, frame_std_meter=0.005,
                        distance_std=0.01, seed=i)
        datasets.append(ds)
        key, sub = jax.random.split(key)
        g = create_grid_net(sub, model_cfg, bound=ds.get_inflated_bound())
        grids.append(g.replace(decoder=dec, decoder_fixed=True))
    key, k0, k1 = jax.random.split(key, 3)
    enc_params = [feature_prediction_init(k0, 4, 3), feature_prediction_init(k1, 4, 3)]
    if export is not None:
        init = Encoder({"model": model_cfg}, trunc_dist=td)
        init.level_params = enc_params
        init.save(export)
        for i, ds in enumerate(datasets):
            draws.update(_poses(f"train{i}", ds))

    def make_step(target_level):
        def step(enc, opt, grid, batch, k, lr):
            def obj(enc):
                d = encoder_pretrain_loss(enc, grid, batch, k, target_level, trunc_dist=td,
                                          pred_std=1e-3)
                return sum(jnp.mean(v) for v in d.values())

            loss, grads = jax.value_and_grad(obj)(enc)
            mask = [tree_full_mask(e) if l == target_level else tree_zero_mask(e)
                    for l, e in enumerate(enc)]
            new_e, new_o = masked_adam_update(grads, opt, enc, mask, lr=lr)
            return new_e, new_o, loss

        return jax.jit(step)

    rng = np.random.default_rng(seed)
    for level in range(2):
        step = make_step(level)
        opt = masked_adam_init(enc_params)
        k = jax.random.PRNGKey(level)
        for _ in range(encoder_epochs):
            i = int(rng.integers(len(datasets)))
            batch = {kk: jnp.asarray(v) for kk, v in datasets[i].sample(rng).items()}
            g = grids[i].replace(Rwk=jnp.asarray(datasets[i].R_world_frame),
                                 twk=jnp.asarray(datasets[i].t_world_frame))
            k, sub = jax.random.split(k)
            enc_params, opt, _ = step(enc_params, opt, g, batch, sub, jnp.float32(1e-3))

    test_mesh = TriangleMesh(*room_scene(5.0, seed=seed))
    ds_obs = PosedSdf3D(test_mesh, frame_batchsize=2 ** 10, frame_samples=2 ** 11,
                        num_frames=32, trunc_dist=td, seed=seed + 50)
    ds_eval = Sdf3D(test_mesh, batch_size=2 ** 14, total_samples=2 ** 16, trunc_dist=td)
    if export is not None:
        draws.update(_poses("test", ds_obs))
        np.savez(os.path.join(export, "draws.npz"), **draws)
    key, sub = jax.random.split(key)
    grid = create_grid_net(sub, model_cfg, bound=ds_obs.get_inflated_bound())
    grid = grid.replace(decoder=dec, decoder_fixed=True, Rwk=jnp.asarray(ds_obs.R_world_frame),
                        twk=jnp.asarray(ds_obs.t_world_frame))
    encoder = Encoder({"model": model_cfg}, trunc_dist=td)
    encoder.level_params = enc_params
    b = ds_obs.sample(np.random.default_rng(seed + 7))
    coords_w = se3.transform_points_by_id(
        jnp.asarray(b["coords_frame"]), jnp.asarray(b["sample_frame_ids"]).reshape(-1),
        jnp.asarray(ds_obs.R_world_frame), jnp.asarray(ds_obs.t_world_frame))
    obs = EncoderObservation(coords_world=coords_w, gt_sdf=jnp.asarray(b["sdf"]),
                             gt_sdf_sign=jnp.asarray(b["sdf_signs"]),
                             gt_sdf_valid=jnp.asarray(b["sdf_valid"]))
    eb = ds_eval.sample(np.random.default_rng(seed + 13))
    ex = jnp.asarray(eb["coords"])
    ey = np.asarray(eb["sdf"]).reshape(-1)
    ev = np.asarray(eb["sdf_valid"]).reshape(-1) > 0
    cfg_opt = {"loss": {"trunc_distance": td, "trunc_weight": 1.0},
               "train": {"optimizer": "adam", "verbose": False}}
    initialize_grid_net(grid, init_mode="encode", encoder=encoder, encoder_observation=obs)
    out = {}
    for mode in ("zero", "encode"):
        g0, info = initialize_grid_net(
            grid, init_mode=mode, encoder=encoder if mode == "encode" else None,
            encoder_observation=obs if mode == "encode" else None)
        curve = {}
        for K in EVAL_EPOCHS:
            gK = g0 if K == 0 else optimize_grid_net(
                g0, ds_obs, cfg_opt, iterations=K, learning_rate=1e-3, train_mode="joint",
                iterations_per_level=max(K // 3, 1), seed=seed)[0]
            curve[K] = float(np.abs(np.asarray(gK(ex)).reshape(-1) - ey)[ev].mean())
        out[mode] = curve
    from miso_tpu.ops.mlp import mlp_apply
    out["decoder_at_zero"] = float(np.asarray(mlp_apply(dec, jnp.zeros((1, 8))))[0, 0])
    return out


def _poses(name, ds):
    return {f"{name}_R_gt": ds.R_world_frame_gt, f"{name}_t_gt": ds.t_world_frame_gt,
            f"{name}_R": ds.R_world_frame, f"{name}_t": ds.t_world_frame}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--decoder_keys", type=int, nargs="+", default=[7, 8, 9, 10, 11, 12])
    ap.add_argument("--out", default=None)
    ap.add_argument("--export", default=None)
    args = ap.parse_args()
    runs = {}
    for k in args.decoder_keys:
        t0 = time.time()
        runs[k] = run(k, export=args.export if k == args.decoder_keys[0] else None)
        print(f"decoder key {k} ({time.time() - t0:.0f} s): {runs[k]}", flush=True)
    stats = {}
    for mode in ("zero", "encode"):
        for K in EVAL_EPOCHS:
            v = np.array([r[mode][K] for r in runs.values()])
            stats[f"{mode}_K{K}"] = dict(mean=float(v.mean()), sd=float(v.std(ddof=1))
                                         if len(v) > 1 else 0.0,
                                         min=float(v.min()), max=float(v.max()))
    out = {"runs": runs, "stats": stats}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
