#!/usr/bin/env python3
"""The JAX package's run on the CPU of ``training/train_decoder.py
--synthetic`` (both paths) with the readings ``chip_smoke.py`` phase 11 (c)
holds the port's run to.

    JAX_PLATFORMS=cpu python3 scripts/jax_train_decoder.py [--epochs 300]
        [--paths parallel round_robin] [--out FILE]

The scenes are the script's: ``room_scene(4 + s, seed=s)`` for s < 4,
``Sdf3D`` (2^14 points a batch, 2^17 samples, truncation 0.15), batches from
``numpy default_rng(0)``, which the port draws alike.  ``parallel`` is
``train_parallel``'s loop (``--parallel``: the scene stack, coarse, fine
and joint stages of ``--epochs`` steps at lr 1e-3, 1e-3, 1e-4) on one
device, written out here to keep the trained grids; ``round_robin`` is the
default path's loop (with ``allow_int`` in its gradient, without which
the JAX script's own default path raises on GridNet's integer leaf).  Readings: each stage's last loss and, per scene, the
SDF MAE of the trained grids and decoder over the valid samples of a
held-out ``Sdf3D`` (seed 100 + s, 2^14 samples; ``heldout_sets``).  Prints
one JSON line and writes it to ``--out``.  The JAX package is imported
read-only.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRUNC = 0.15
HELDOUT_SAMPLES = 2 ** 14


def scenes():
    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.native import TriangleMesh

    meshes = [TriangleMesh(*room_scene(4.0 + s, seed=s)) for s in range(4)]
    return meshes, [Sdf3D(m, batch_size=2 ** 14, total_samples=2 ** 17, trunc_dist=TRUNC)
                    for m in meshes]


def heldout_sets(meshes):
    """Per scene (coords, sdf) of the valid samples of Sdf3D(seed=100 + s)."""
    from miso_tpu.datasets.sdf_3d import Sdf3D

    out = []
    for s, m in enumerate(meshes):
        ds = Sdf3D(m, batch_size=HELDOUT_SAMPLES, total_samples=HELDOUT_SAMPLES,
                   trunc_dist=TRUNC, seed=100 + s)
        keep = ds.sdf_valid[:, 0] == 1
        out.append((ds.coords[keep], ds.sdfs[keep]))
    return out


def run_parallel(datasets, epochs):
    import jax
    import jax.numpy as jnp
    from miso_tpu.models.grid_atlas import grid_atlas_mask
    from miso_tpu.parallel.pretrain import (build_scene_stack, scene_parallel_decoder_step,
                                            stack_scene_batches)
    from miso_tpu.train.optim import masked_adam_init

    model_cfg = _model_cfg()
    params = build_scene_stack(model_cfg, [ds.bound for ds in datasets],
                               jax.random.PRNGKey(0)).params
    step = scene_parallel_decoder_step(trunc_dist=TRUNC)
    rng = np.random.default_rng(0)
    k = jax.random.PRNGKey(1)
    L = params.num_levels
    losses = {}
    for name, lr, level, ignore_fine in (("coarse", 1e-3, 0, True), ("fine", 1e-3, 1, False),
                                         ("joint", 1e-4, L, False)):
        ig = jnp.asarray([0.0, 1.0] if ignore_fine else [0.0, 0.0])[:L]
        params = params.replace(ignore_level=ig)
        mask = grid_atlas_mask(params, features=True, stability=True, decoder=True,
                               anchor_first_submap=False, level=level)
        opt = masked_adam_init(params)
        for e in range(epochs):
            batches = stack_scene_batches([ds.sample(rng) for ds in datasets])
            k, sub = jax.random.split(k)
            params, opt, tl = step(params, opt, batches, sub, mask, jnp.float32(lr))
        losses[name] = float(tl)

    def field(s, x):
        return np.asarray(params.forward_submap(s, jnp.asarray(x)))
    return losses, field


def run_round_robin(datasets, epochs):
    import jax
    import jax.numpy as jnp
    from miso_tpu.losses.common import total_loss
    from miso_tpu.losses.miso import make_loss
    from miso_tpu.losses.sdf import tsdf_loss_3d
    from miso_tpu.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu.train.optim import masked_adam_init, masked_adam_update

    model_cfg = _model_cfg()
    key = jax.random.PRNGKey(0)
    grids = []
    for ds in datasets:
        key, sub = jax.random.split(key)
        grids.append(create_grid_net(sub, model_cfg, bound=ds.bound))
    grids = [g.replace(decoder=grids[0].decoder) for g in grids]
    loss_fn = make_loss(tsdf_loss_3d, sdf_weight=3e3, sign_weight=1e2, eik_weight=5e1,
                        trunc_dist=TRUNC)

    def step(grid, opt_state, batch, k, mask, lr):
        def obj(g):
            return total_loss(loss_fn(g, batch, k))
        # allow_int: GridNet's anchor_kf is an integer leaf.  The JAX
        # package's script omits it, and its default path raises there.
        tl, grads = jax.value_and_grad(obj, allow_int=True)(grid)
        new_g, new_o = masked_adam_update(grads, opt_state, grid, mask, lr=lr)
        return new_g, new_o, tl

    step = jax.jit(step)
    losses = {}
    for name, lr, level, ignore_fine in (("coarse", 1e-3, 0, True), ("fine", 1e-3, 1, False),
                                         ("joint", 1e-4, 2, False)):
        opts = [masked_adam_init(g) for g in grids]
        rng = np.random.default_rng(0)
        k = jax.random.PRNGKey(1)
        for e in range(epochs):
            i = e % len(grids)
            g = grids[i].with_ignore_level([1] if ignore_fine else [])
            mask = grid_net_mask(g, level=level, pose=False)
            batch = {kk: jnp.asarray(v) for kk, v in datasets[i].sample(rng).items()}
            k, sub = jax.random.split(k)
            g, opts[i], tl = step(g, opts[i], batch, sub, mask, jnp.float32(lr))
            grids = [gr.replace(decoder=g.decoder) if j != i else g
                     for j, gr in enumerate(grids)]
        losses[name] = float(tl)
    grids = [g.with_ignore_level([]) for g in grids]

    def field(s, x):
        return np.asarray(grids[s](jnp.asarray(x)))
    return losses, field


def _model_cfg():
    return {
        "spatial_dim": 3,
        "grid": {"type": "regular", "feature_dim": 4, "init_stddev": 1e-4,
                 "bound": None, "base_cell_size": 0.5, "per_level_scale": 5.0,
                 "n_levels": 2},
        "decoder": {"type": "mlp", "hidden_dim": 64, "hidden_layers": 1,
                    "out_dim": 1, "pos_invariant": True, "fix": False,
                    "pretrained_model": None},
        "pose": {"optimize": False, "num_poses": 1},
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--paths", nargs="+", default=["parallel", "round_robin"])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    meshes, datasets = scenes()
    held = heldout_sets(meshes)
    out = {"epochs": args.epochs}
    for path in args.paths:
        t0 = time.perf_counter()
        losses, field = (run_parallel if path == "parallel" else run_round_robin)(
            datasets, args.epochs)
        mae = [float(np.mean(np.abs(field(s, c) - d))) for s, (c, d) in enumerate(held)]
        out[path] = {"stage_losses": losses, "mae": mae, "seconds": time.perf_counter() - t0}
        print(path, out[path], flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
