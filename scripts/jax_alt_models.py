#!/usr/bin/env python3
"""The JAX package's run of chip_smoke.py phase 9's configurations on the
CPU: the reference of its F-score, Chamfer and MAE gates.

    JAX_PLATFORMS=cpu python3 scripts/jax_alt_models.py [--out FILE] [--models isdf ngp ...]
                                                        [--keys 0 1 ...] [--own_draws]

(a) room_scene(4.0), Sdf3D with 2^15 points a batch, 2^18 samples and
trunc_dist 0.3; each model of ``chip_smoke.ALT_MODELS`` built through the
JAX config registry from ``chip_smoke.alt_model_cfg`` (PRNG key 0, or each
of ``--keys``: the spread over the random draws; PointSDF's features and
decoder then replaced by ``chip_smoke.alt_draws`` of that seed, the port's
draws in phase 9, unless ``--own_draws``), trained by
the base Trainer with Adam for ``chip_smoke.ALT_EPOCHS`` epochs of
tsdf_loss_3d (``chip_smoke.ALT_LOSS``) at ``chip_smoke.ALT_LR``, meshed at
128^3 with save_mesh and scored with mesh_reconstruction_metrics.
(b) ``chip_smoke.alt_image()`` in Sdf2D at 0.05 m a pixel, a 2D GridNet
(``chip_smoke.alt_2d_cfg``, features and decoder from ``chip_smoke.alt_draws``
unless ``--own_draws``) trained 150 epochs with the Sdf2D loss entry;
its MAE over the image, mean |SDF| on the boundary pixels, MAE inside the
obstacles, the prediction's minimum, and how many of its decoder's last
hidden units with a negative output weight stay live.

The trainers get a mask with bound, Rwk, twk, ignore_level and points at 0:
the base Trainer's default full mask would train them (ROADMAP Queue 3),
which the port, holding them as buffers, does not.  Prints each reading and
its seconds, and writes them as JSON to ``--out``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (configuration only; imports torch, not the port)


def buffer_free_mask(model):
    from miso_tpu.models.base import tree_full_mask, tree_zero_mask
    zero = {k: tree_zero_mask(getattr(model, k))
            for k in ("bound", "Rwk", "twk", "ignore_level", "points") if hasattr(model, k)}
    return tree_full_mask(model).replace(**zero)


def shared_draws(model, layernorm, std, seed):
    """The model with its features and decoder replaced by
    ``chip_smoke.alt_draws`` of their shapes."""
    import jax.numpy as jnp
    single = not isinstance(model.features, (tuple, list))
    features = [model.features] if single else list(model.features)
    Ws = [layer[0] if len(layer) == 2 else layer[2] for layer in model.decoder]
    dims = [W.shape[0] for W in Ws] + [Ws[-1].shape[1]]
    feats, layers = cs.alt_draws([f.shape for f in features], std, dims, layernorm, seed)
    feats = [jnp.asarray(f) for f in feats]
    return model.replace(features=feats[0] if single else tuple(feats),
                         decoder=tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers))


def run_3d(names, keys, own_draws):
    import jax
    from miso_tpu import config as j_config
    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.losses.miso import make_loss
    from miso_tpu.losses.sdf import tsdf_loss_3d
    from miso_tpu.native import TriangleMesh
    from miso_tpu.train.trainer import Trainer
    from miso_tpu.utils.eval import mesh_reconstruction_metrics
    from miso_tpu.utils.sdf import save_mesh

    scene = TriangleMesh(*room_scene(4.0))
    ds = Sdf3D(scene, batch_size=cs.MESH_BATCH, total_samples=cs.MESH_SAMPLES, trunc_dist=0.3)
    bound = ds.bound.tolist()
    loss_fn = make_loss(tsdf_loss_3d, **cs.ALT_LOSS)
    out = {}
    for name, key in ((n, k) for n in names for k in keys):
        cfg = {"model": {**cs.alt_model_cfg(name, bound), "name": cs.ALT_REGISTRY[name]}}
        model = j_config.cfg_model(cfg, jax.random.PRNGKey(key),
                                   **({"mesh": scene} if name == "pointsdf" else {}))
        if name in cs.ALT_SHARED_DRAWS and not own_draws:
            model = shared_draws(model, True, 0.01, key)
        t0 = time.perf_counter()
        model = Trainer({"optimizer": "adam", "learning_rate": cs.ALT_LR[name],
                         "epochs": cs.ALT_EPOCHS}, model, loss_fn, ds,
                        mask=buffer_free_mask(model)).train()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = save_mesh(model, np.asarray(model.bound), None, resolution=cs.ALT_RESOLUTION)
        mesh_s = time.perf_counter() - t0
        metrics = mesh_reconstruction_metrics(mesh, scene, n_points=cs.MESH_METRIC_POINTS)
        out[name if keys == [0] else f"{name}@{key}"] = dict(
            train_s=train_s, mesh_s=mesh_s, metrics=metrics)
        print(f"{name} (key {key}): trained in {train_s:.1f} s, meshed in {mesh_s:.1f} s: "
              f"F-score {metrics['F-score (%)']!r} %, Chamfer_L1 {metrics['Chamfer_L1 (cm)']!r} cm",
              flush=True)
    return out


def negative_units_live(model, x):
    """How many units of the decoder's last hidden layer have a negative
    output weight and fire at one point of ``x`` at least: the units that can
    take the output below its bias."""
    import jax
    import jax.numpy as jnp
    h = model.query_feature(x)
    for W, b in model.decoder[:-1]:
        h = jax.nn.relu(h @ W + b)
    live = np.asarray(jnp.any(h > 0, axis=0))
    return int(np.sum(live & (np.asarray(model.decoder[-1][0])[:, 0] < 0)))


def run_2d(keys, own_draws):
    import jax
    import jax.numpy as jnp
    from miso_tpu import config as j_config
    from miso_tpu.datasets.sdf_2d import Sdf2D
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.train.trainer import Trainer

    ds = Sdf2D(cs.alt_image(), cell_size=cs.ALT_2D["cell"])
    out = {}
    for key in keys:
        model = create_grid_net(jax.random.PRNGKey(key), cs.alt_2d_cfg(ds.bound.tolist()))
        if not own_draws:
            model = shared_draws(model, False, cs.ALT_2D_INIT_STD, key)
        t0 = time.perf_counter()
        model = Trainer({"optimizer": "adam", "learning_rate": cs.ALT_2D["lr"],
                         "epochs": cs.ALT_2D["epochs"]}, model,
                        j_config.cfg_loss({"loss": {"name": "Sdf2D"}}), ds,
                        mask=buffer_free_mask(model)).train()
        train_s = time.perf_counter() - t0
        x = jnp.asarray(ds.full_coords.reshape(-1, 2))
        pred = np.asarray(model(x))
        r = cs.alt_2d_readings(pred, ds)
        r["negative_units_live"] = negative_units_live(model, x)
        out["grid2d" if keys == [0] else f"grid2d@{key}"] = dict(train_s=train_s, **r)
        print(f"grid2d (key {key}): trained in {train_s:.1f} s: MAE {r['mae']!r} m, boundary "
              f"|SDF| {r['boundary_abs_sdf']!r} m, inside MAE {r['inside_mae']!r} m, prediction "
              f"minimum {r['pred_min']!r} m, {r['negative_units_live']} live last-layer units "
              f"with a negative output weight", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--models", nargs="*", default=list(cs.ALT_MODELS) + ["grid2d"])
    ap.add_argument("--keys", nargs="*", type=int, default=[0])
    ap.add_argument("--own_draws", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    res = run_3d([m for m in args.models if m != "grid2d"], args.keys, args.own_draws)
    if "grid2d" in args.models:
        res.update(run_2d(args.keys, args.own_draws))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
