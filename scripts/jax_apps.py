#!/usr/bin/env python3
"""The JAX package's run on the CPU of what ``chip_smoke.py`` phase 10's
gates read: the reference of its bf16 training and apps gates.

    JAX_PLATFORMS=cpu python3 scripts/jax_apps.py [--out FILE] [--work DIR] [--skip_build]
        [--bf16_keys K ...] [--own_draws] [--bf16_only] [--noise DEG M]

(a) ``tests/test_train_e2e.py::test_bf16_features``'s recipe: an
icosphere's SDF, a GridNet with ``grid.feature_dtype: bfloat16`` from the
port's initial draws (``chip_smoke.alt_draws`` of each of ``--bf16_keys``,
default 0; with ``--own_draws`` the JAX package's ``PRNGKey(key)``) trained
150 epochs by GridTrainer; the SDF MAE on a fresh batch
(``chip_smoke.APPS_BF16``).  ``--bf16_only`` stops here.
(b) ``demo/build_submaps.py --synthetic`` at its defaults (24 frames, 300
mapping iterations a submap, 50 a level, the 256^3 final mesh), run as the
demo itself into ``--work`` (default ``results/torch/jax_apps``): its
results and the final mesh's F-score and Chamfer_L1 against the room
(``chip_smoke.APPS_MESH_METRICS``).
(c) That atlas (``grid_atlas.npz``, loaded with the JAX package's
``load_pytree`` over the demo's dry-run structure) aligned as
``align_submaps --atlas ... --method miso --use_sdf`` aligns it in the port:
every submap but the first perturbed by 3 degrees and 15 cm
(``numpy default_rng(0)``), latent levels 0 and 1 and the SDF finetune, 150
iterations each, lr 5e-3; the rotation and translation RMSE of the submap
poses before and after, against the poses the atlas was saved with.
``--noise 0 0`` aligns it from those poses themselves.
(d) ``demo/align_submaps.py --method miso --use_sdf`` at its defaults (no
``--atlas``: the demo's own synthetic two-submap atlas), run as the demo
itself: its results.
Prints each reading and its seconds, and writes them as JSON to ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (configuration only; imports torch, not the port)


def bf16_features(key=0, own_draws=False):
    """tests/test_train_e2e.py:113-155, the MAE it asserts under 0.03, from
    alt_draws(key) or with ``own_draws`` from PRNGKey(key)."""
    import jax
    import jax.numpy as jnp

    from miso_tpu.datasets.sdf_3d import Sdf3D
    from miso_tpu.datasets.shapes import icosphere
    from miso_tpu.losses.miso import make_loss
    from miso_tpu.losses.sdf import tsdf_loss_3d
    from miso_tpu.models.grid_net import create_grid_net
    from miso_tpu.native import TriangleMesh
    from miso_tpu.train.trainer import GridTrainer

    r = cs.APPS_BF16
    ds = Sdf3D(TriangleMesh(*icosphere(3, 0.6)), **r["dataset"])
    cfg = cs.apps_bf16_cfg(ds.bound.tolist())
    model = create_grid_net(jax.random.PRNGKey(key), cfg)
    assert model.features[0].dtype == jnp.bfloat16
    if not own_draws:
        # The port's initial draws (chip_smoke.alt_draws), features rounded to bf16.
        dims = [W.shape[0] for W, _ in model.decoder] + [model.decoder[-1][0].shape[1]]
        feats, layers = cs.alt_draws([f.shape for f in model.features],
                                     cfg["grid"]["init_stddev"], dims, False, key)
        model = model.replace(
            features=tuple(jnp.asarray(f).astype(jnp.bfloat16) for f in feats),
            decoder=tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in layers))
    loss_fn = make_loss(tsdf_loss_3d, **r["loss"])
    model = GridTrainer(r["train"], model, loss_fn, ds).train()
    b = ds.sample(np.random.default_rng(r["eval_seed"]))
    pred = np.asarray(model(jnp.asarray(b["coords"])).astype(jnp.float32)).reshape(-1)
    valid = np.asarray(b["sdf_valid"]).reshape(-1) > 0
    return float(np.abs(pred - np.asarray(b["sdf"]).reshape(-1))[valid].mean())


def build_submaps_cfg():
    """configs/rgbd/scannet.yaml with demo/build_submaps.py's synthetic
    overrides (:53-69), and its sequence."""
    from miso_tpu.config import load_config
    from miso_tpu.datasets.sequence import SdfSequence, orbit_trajectory
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.native import TriangleMesh
    cfg = load_config(os.path.join(ROOT, "configs", "rgbd", "scannet.yaml"))
    R, t = orbit_trajectory([0, 0, 0], 1.8, 1.4, 24, look_at=[0, 0, -0.5])
    ds = SdfSequence(TriangleMesh(*room_scene(5.0, seed=0)), R, t, frame_samples=2 ** 12,
                     frame_batchsize=2048, trunc_dist=0.3, near_surface_std=0.1)
    bound = [[-3.5, 3.5], [-3.5, 3.5], [-2.0, 2.0]]
    cfg["system"].update({"submap_size": 8, "submap_local_bound": bound})
    cfg["model"]["grid"].update({"base_cell_size": 1.0, "per_level_scale": 4.0, "bound": bound})
    cfg["model"]["decoder"].update({"fix": False, "pretrained_model": None, "hidden_dim": 32})
    cfg["model"]["pose"]["num_poses"] = 8
    return cfg, ds


def build_submaps(work):
    """The JAX demo's own run; its results and its final mesh's metrics."""
    from miso_tpu.datasets.shapes import room_scene
    from miso_tpu.native import TriangleMesh
    from miso_tpu.utils.eval import mesh_reconstruction_metrics
    from miso_tpu.utils.sdf import read_ply
    subprocess.run([sys.executable, os.path.join(ROOT, "demo", "build_submaps.py"),
                    "--synthetic", "--save_dir", work], check=True, cwd=ROOT)
    with open(os.path.join(work, "results.json")) as f:
        res = json.load(f)
    mesh = TriangleMesh(*read_ply(os.path.join(work, "mesh_final.ply")))
    res["mesh_metrics"] = mesh_reconstruction_metrics(
        mesh, TriangleMesh(*room_scene(5.0, seed=0)), **cs.APPS_MESH_METRICS)
    return res


def align_atlas(work, noise_deg, noise_m):
    """The saved atlas, perturbed by ``noise_deg`` / ``noise_m`` and aligned
    as the port's align_submaps --atlas --method miso --use_sdf does it."""
    import jax.numpy as jnp

    from miso_tpu.align.miso import align_multiple_submaps_hierarchical
    from miso_tpu.models.grid_atlas import GridAtlas
    from miso_tpu.ops import se3
    from miso_tpu.train.checkpoint import load_meta, load_pytree
    cfg, _ = build_submaps_cfg()
    path = os.path.join(work, "grid_atlas.npz")
    meta = load_meta(path)
    with np.load(path) as data:
        bounds, Rws, tws = (data[f"arr::.{k}"] for k in ("bounds", "Rws", "tws"))
    atlas = GridAtlas(cfg["model"], max_kfs_per_submap=cfg["system"]["submap_size"],
                      capacity=cfg["system"].get("submap_capacity"))
    for s in range(meta["num_submaps"]):
        atlas.add_submap(bounds[s], Rws[s], tws[s])
        for _ in range(meta["kf_to_submap"].count(s)):
            atlas.add_kf()
    atlas.params = load_pytree(path, like=atlas.params)
    gt_R, gt_t = (np.asarray(v) for v in atlas.params.updated_submap_poses())
    a = cs.APPS_ALIGN
    rng = np.random.default_rng(a["seed"])
    for s in range(1, atlas.num_submaps):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        dt = rng.standard_normal(3)
        atlas.set_submap_pose_correction(
            s, (axis * np.radians(noise_deg)).astype(np.float32),
            (dt / np.linalg.norm(dt) * noise_m).astype(np.float32))

    S = atlas.num_submaps       # the live slots of the capacity-padded storage

    def errors():
        R, t = atlas.params.updated_submap_poses()
        rot = float(se3.rotation_rmse_deg(R[1:S], jnp.asarray(gt_R[1:S])))
        return rot, float(np.sqrt(((np.asarray(t[1:S]) - gt_t[1:S]) ** 2).sum(-1).mean()))

    before = errors()
    t0 = time.time()
    align_multiple_submaps_hierarchical(
        atlas, level_iters=a["iters"], finetune_iters=a["iters"], lr=a["lr"], align_loss="L2",
        latent_levels=[0, 1], skip_finetune=False, verbose=False, seed=a["seed"])
    after = errors()
    return dict(rot_rmse_deg_before=before[0], trans_rmse_m_before=before[1],
                rot_rmse_deg_after=after[0], trans_rmse_m_after=after[1],
                align_time_sec=time.time() - t0)


def align_synthetic(work):
    """The JAX demo's own run on its synthetic atlas; its results."""
    save_dir = os.path.join(work, "align_synthetic")
    subprocess.run([sys.executable, os.path.join(ROOT, "demo", "align_submaps.py"),
                    "--method", "miso", "--use_sdf", "--save_dir", save_dir],
                   check=True, cwd=ROOT)
    with open(os.path.join(save_dir, "results.json")) as f:
        return json.load(f)


def apps(args, out):
    """(b)-(d) into ``out``."""
    t0 = time.time()
    if not args.skip_build:
        out["build_submaps"] = build_submaps(args.work)
        out["build_submaps_s"] = time.time() - t0
        m = out["build_submaps"]["mesh_metrics"]
        print(f"build_submaps: {out['build_submaps']['num_submaps']} submaps, F-score "
              f"{m['F-score (%)']:.4f} %, Chamfer_L1 {m['Chamfer_L1 (cm)']:.4f} cm "
              f"({out['build_submaps_s']:.1f} s)", flush=True)
    t0 = time.time()
    out["align"] = align_atlas(args.work, *args.noise)
    out["align_s"] = time.time() - t0
    a = out["align"]
    print(f"align_submaps --atlas: {a['rot_rmse_deg_before']:.4f} deg / "
          f"{100 * a['trans_rmse_m_before']:.3f} cm -> {a['rot_rmse_deg_after']:.4f} deg / "
          f"{100 * a['trans_rmse_m_after']:.3f} cm ({out['align_s']:.1f} s)", flush=True)
    t0 = time.time()
    out["align_synthetic"] = align_synthetic(args.work)
    out["align_synthetic_s"] = time.time() - t0
    a = out["align_synthetic"]
    print(f"align_submaps (synthetic atlas): {a['rot_rmse_deg_before']:.4f} deg / "
          f"{100 * a['trans_rmse_m_before']:.3f} cm -> {a['rot_rmse_deg_after']:.4f} deg / "
          f"{100 * a['trans_rmse_m_after']:.3f} cm ({out['align_synthetic_s']:.1f} s)",
          flush=True)



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--work", default=os.path.join(ROOT, "results", "torch", "jax_apps"))
    ap.add_argument("--skip_build", action="store_true",
                    help="reuse the demo's run already in --work")
    ap.add_argument("--bf16_keys", nargs="*", type=int, default=[0])
    ap.add_argument("--own_draws", action="store_true",
                    help="the bf16 recipe from the JAX package's own draws")
    ap.add_argument("--bf16_only", action="store_true")
    ap.add_argument("--noise", nargs=2, type=float,
                    default=[cs.APPS_ALIGN["noise_deg"], cs.APPS_ALIGN["noise_m"]],
                    metavar=("DEG", "M"), help="the --atlas alignment's perturbation")
    args = ap.parse_args()
    out = {}
    maes = {}
    for key in args.bf16_keys:
        t0 = time.time()
        maes[key] = bf16_features(key, args.own_draws)
        print(f"bf16 features, {'own' if args.own_draws else 'shared'} draws, key {key}: "
              f"MAE {maes[key]:.6f} ({time.time() - t0:.1f} s)", flush=True)
    out["bf16_features_mae"] = maes[args.bf16_keys[0]]
    if len(maes) > 1:
        v = np.array(list(maes.values()))
        out["bf16_features_mae_by_key"] = maes
        print(f"bf16 features: mean {v.mean():.6f}, s.d. {v.std(ddof=1):.6f}, "
              f"{v.min():.6f}-{v.max():.6f}", flush=True)
    if not args.bf16_only:
        apps(args, out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
