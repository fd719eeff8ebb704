#!/usr/bin/env python3
"""The JAX package's in-system encoder recipe of tests/test_encoder_system.py
on the CPU, as the reference for chip_smoke.py phase 8 (b).

    JAX_PLATFORMS=cpu python3 scripts/jax_encoder_system.py [--export DIR] [--out FILE]

Pretrains the decoder as tests/test_slam.py's fixture does (room_scene(4.0),
200 epochs, 60 a level, drawn from PRNGKey(7)), the per-level encoders 60
steps a level on two held-out PosedSdf3D rooms, then runs System over the
12-frame orbit (2 submaps of 6 keyframes, LM tracking) at zero@30, zero@10
and encode@10 init iterations, and prints the three map errors (the mean
|SDF| of the atlas at 512 true surface points of keyframes 3 and 9), then
them as JSON (also to ``--out``).

``--export DIR`` writes what the port's run of the recipe starts from:
``DIR/draws.npz`` (the pretrained decoder's ``W{i}``/``b{i}``; the camera
rotations, true positions and poses ``{name}_R_gt``, ``{name}_t_gt``,
``{name}_R``, ``{name}_t`` of the encoder datasets ``train0`` and
``train1``) and ``DIR/feature_encoder_level_{l}.npz`` (the encoders' initial
parameters, the JAX package's ``Encoder.save``).
"""
import argparse
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

TRUNC = 0.3


def pretrain_decoder(model_cfg):
    """tests/test_slam.py::pretrained_decoder_path's decoder."""
    import jax

    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.losses.miso import make_loss
    from miso_tpu.losses.sdf import tsdf_loss_3d
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.native import TriangleMesh
    from miso_tpu.train.trainer import GridTrainer

    ds = Sdf3D(TriangleMesh(*room_scene(4.0, seed=0)), batch_size=2 ** 13,
               total_samples=2 ** 16, trunc_dist=TRUNC)
    cfg = dict(model_cfg)
    cfg["decoder"] = dict(model_cfg["decoder"], fix=False, pretrained_model=None)
    model = create_grid_net(jax.random.PRNGKey(7), cfg)
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=0.0,
                        trunc_dist=TRUNC)
    return GridTrainer({"optimizer": "adam", "learning_rate": 5e-3, "epochs": 200,
                        "max_epochs_in_level": 60,
                        "grid_training_mode": "coordinate+joint"},
                       model, loss_fn, ds).train().decoder


def pretrain_encoders(model_cfg, dec, export=None):
    """tests/test_encoder_system.py::pretrained_encoders with ``dec``."""
    import jax
    import jax.numpy as jnp

    from miso_tpu.datasets.sdf_3d import PosedSdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.models.base import tree_full_mask, tree_zero_mask
    from miso_tpu.models.encoder import Encoder, encoder_pretrain_loss, feature_prediction_init
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.native import TriangleMesh
    from miso_tpu.train.optim import masked_adam_init, masked_adam_update

    cfg = copy.deepcopy(model_cfg)
    cfg["decoder"]["fix"] = True
    datasets, grids, draws = [], [], {}
    key = jax.random.PRNGKey(3)
    for i in range(2):
        mesh = TriangleMesh(*room_scene(4.0 + 0.5 * i, seed=10 + i))
        ds = PosedSdf3D(mesh, frame_batchsize=2 ** 9, frame_samples=2 ** 10, num_frames=16,
                        trunc_dist=TRUNC, seed=i)
        datasets.append(ds)
        draws.update({f"train{i}_R_gt": ds.R_world_frame_gt, f"train{i}_t_gt": ds.t_world_frame_gt,
                      f"train{i}_R": ds.R_world_frame, f"train{i}_t": ds.t_world_frame})
        key, sub = jax.random.split(key)
        g = create_grid_net(sub, cfg, bound=ds.get_inflated_bound(), num_poses=16)
        grids.append(g.replace(decoder=dec, decoder_fixed=True,
                               Rwk=jnp.asarray(ds.R_world_frame),
                               twk=jnp.asarray(ds.t_world_frame)))
    key, k0, k1 = jax.random.split(key, 3)
    fdim = cfg["grid"]["feature_dim"]
    enc_params = [feature_prediction_init(k, fdim, 3) for k in (k0, k1)]
    if export is not None:
        init = Encoder({"model": cfg}, trunc_dist=TRUNC)
        init.level_params = enc_params
        init.save(export)
        draws.update({f"{w}{i}": np.asarray(a) for i, (W, b) in enumerate(dec)
                      for w, a in (("W", W), ("b", b))})
        np.savez(os.path.join(export, "draws.npz"), **draws)

    def make_step(target_level):
        def step(enc, opt, grid, batch, k, lr):
            def obj(enc):
                d = encoder_pretrain_loss(enc, grid, batch, k, target_level, trunc_dist=TRUNC,
                                          pred_std=1e-3)
                return sum(jnp.mean(v) for v in d.values())

            loss, grads = jax.value_and_grad(obj)(enc)
            mask = [tree_full_mask(e) if l == target_level else tree_zero_mask(e)
                    for l, e in enumerate(enc)]
            new_e, new_o = masked_adam_update(grads, opt, enc, mask, lr=lr)
            return new_e, new_o, loss

        return jax.jit(step)

    rng = np.random.default_rng(0)
    for level in range(len(enc_params)):
        step = make_step(level)
        opt = masked_adam_init(enc_params)
        k = jax.random.PRNGKey(level)
        for _ in range(60):
            i = int(rng.integers(len(datasets)))
            batch = {kk: np.asarray(v) for kk, v in datasets[i].sample(rng).items()}
            k, sub = jax.random.split(k)
            enc_params, opt, _ = step(enc_params, opt, grids[i], batch, sub, np.float32(1e-3))
    return enc_params


def run_system(seq, model_cfg, cfg, dec_path, init_mode, init_iters, enc_params=None):
    """tests/test_encoder_system.py::_run_system."""
    import jax.numpy as jnp

    from miso_tpu.models.encoder import Encoder
    from miso_tpu.models.grid_atlas import GridAtlas
    from miso_tpu.slam.system import System

    model_cfg = copy.deepcopy(model_cfg)
    model_cfg["decoder"].update({"fix": True, "pretrained_model": dec_path})
    cfg = copy.deepcopy(cfg)
    cfg["system"].update({"submap_size": 6, "submap_init_mode": init_mode})
    cfg["mapping"].update({"init_iterations": init_iters, "init_iterations_encode": init_iters,
                           "iters_per_frame": 6, "level_iters_per_frame": 2})
    encoder = None
    if init_mode == "encode":
        encoder = Encoder({"model": model_cfg}, trunc_dist=TRUNC)
        encoder.level_params = list(enc_params)
    atlas = GridAtlas(model_cfg, max_kfs_per_submap=6)
    R0, t0 = seq.true_kf_pose_in_world(0)
    System(atlas, seq, seq, cfg, R_world_origin=R0, t_world_origin=t0, encoder=encoder).run()
    errs = []
    for kf in (3, 9):
        pts = seq.sampled_points_at_kf(kf)[:512]
        R, t = seq.true_kf_pose_in_world(kf)
        world = pts @ np.asarray(R).T + np.asarray(t)
        errs.append(float(np.abs(np.asarray(atlas.params(jnp.asarray(world)))).mean()))
    return float(np.mean(errs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--export", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from miso_tpu.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.native import TriangleMesh
    from miso_tpu.train.checkpoint import save_pytree
    from test_slam import CFG, MODEL_CFG

    t0 = time.time()
    cfg = copy.deepcopy(CFG)
    tmp = tempfile.mkdtemp(prefix="jax_encoder_system_")
    cfg["system"]["log_dir"] = tmp
    R, t = orbit_trajectory(center=[0, 0, 0], radius=1.4, height=1.2, num_frames=12,
                            look_at=[0, 0, -0.5])
    seq = SdfSequence(TriangleMesh(*room_scene(4.0, seed=0)), R, t, frame_samples=2 ** 11,
                      frame_batchsize=2048, trunc_dist=TRUNC, near_surface_std=0.1, seed=1)
    dec = pretrain_decoder(MODEL_CFG)
    dec_path = os.path.join(tmp, "decoder.npz")
    save_pytree(dec_path, dec)
    enc_params = pretrain_encoders(MODEL_CFG, dec, args.export)
    setup_s = time.time() - t0
    err = {}
    for mode, iters in (("zero", 30), ("zero", 10), ("encode", 10)):
        err[f"{mode}@{iters}"] = run_system(seq, MODEL_CFG, cfg, dec_path, mode, iters, enc_params)
        print(f"{mode}@{iters}: map error {1e3 * err[f'{mode}@{iters}']:.3f} mm", flush=True)
    out = {"err": err, "setup_s": setup_s, "seconds": time.time() - t0}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
