#!/usr/bin/env python3
"""The JAX package's alignment baselines and InfoNCE alignment on
demo/align_submaps.py's synthetic atlas, as the reference of chip_smoke.py
phase 7's runs (b)-(e).

    JAX_PLATFORMS=cpu python3 scripts/jax_align_baselines.py [--out FILE]

Builds the demo's atlas once (``demo/align_submaps.py::build_synthetic_atlas``,
seed 0), keeps its trained parameters, and runs each method from them with
the demo's perturbation of submap 1 (3 degrees, 15 cm, drawn from
``np.random.default_rng(0)``):

  vfpp     ``--method vfpp``: 8192 observations a submap in its frame,
           trunc_dist 0.3, 4096 points a step, 150 iterations at lr 5e-3;
  mips     ``--method mips``: the same with surf_tol 0.02;
  icp      ``--method icp``: ``align_multiple_submaps_icp`` at its defaults;
  infonce  ``align_multiple_submaps_hierarchical(align_loss="InfoNCE",
           latent_levels=[0, 1], skip_finetune=True, subsample_points=4096)``,
           150 iterations a level at lr 5e-3.

Prints each run's rotation and translation RMSE of submap 1 before and after
and its seconds, and writes them as JSON to ``--out`` (default: stdout only).
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

ITERS = 150
LR = 5e-3
NOISE_DEG = 3.0
NOISE_M = 0.15
SUBSAMPLE = 4096


def _demo():
    spec = importlib.util.spec_from_file_location(
        "align_submaps", os.path.join(ROOT, "demo", "align_submaps.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def perturb(atlas, seed=0):
    """demo/align_submaps.py's perturbation of every submap but 0."""
    rng = np.random.default_rng(seed)
    for s in range(1, atlas.num_submaps):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        dt = rng.standard_normal(3)
        atlas.set_submap_pose_correction(
            s, (axis * np.radians(NOISE_DEG)).astype(np.float32),
            (dt / np.linalg.norm(dt) * NOISE_M).astype(np.float32))


def pose_errors(atlas, ds):
    import jax.numpy as jnp

    from miso_tpu.ops import se3
    S = atlas.num_submaps
    gt_R = np.stack([ds.true_submap_pose(s)[0] for s in range(S)])
    gt_t = np.stack([ds.true_submap_pose(s)[1] for s in range(S)])
    R, t = atlas.params.updated_submap_poses()
    rot = float(se3.rotation_rmse_deg(jnp.asarray(R[1:]), jnp.asarray(gt_R[1:])))
    tr = float(np.sqrt(((np.asarray(t[1:]) - gt_t[1:]) ** 2).sum(-1).mean()))
    return rot, tr


def run(method, atlas, ds):
    import jax.numpy as jnp

    from miso_tpu.align.baselines import (align_multiple_submaps_icp, pairwise_loss_mips,
                                          pairwise_loss_vfpp)
    from miso_tpu.align.miso import (align_multiple_submaps_hierarchical,
                                     generic_align_multiple_submaps)
    if method in ("vfpp", "mips"):
        rngb = np.random.default_rng(0)
        obs = {s: tuple(jnp.asarray(a) for a in ds.observations(s, rngb))
               for s in range(atlas.num_submaps)}
        fn = pairwise_loss_vfpp if method == "vfpp" else pairwise_loss_mips
        kw = {"trunc_dist": 0.3} if method == "vfpp" else {"surf_tol": 0.02}

        def pair_loss(params, s, d, key, ctx):
            return fn(params, atlas, s, d, *ctx[s], key=key, subsample_points=SUBSAMPLE, **kw)

        generic_align_multiple_submaps(atlas, pair_loss, num_iters=ITERS, lr=LR, seed=0,
                                       loss_ctx=obs)
    elif method == "icp":
        return align_multiple_submaps_icp(atlas)
    else:
        align_multiple_submaps_hierarchical(
            atlas, level_iters=ITERS, lr=LR, align_loss="InfoNCE", latent_levels=[0, 1],
            skip_finetune=True, subsample_points=SUBSAMPLE, seed=0)
    return {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--methods", nargs="*", default=["vfpp", "mips", "icp", "infonce"])
    args = ap.parse_args()
    t0 = time.perf_counter()
    atlas, ds = _demo().build_synthetic_atlas(0)
    trained = atlas.params
    out = {"build_s": time.perf_counter() - t0}
    print(f"atlas built in {out['build_s']:.1f} s", flush=True)
    for method in args.methods:
        atlas.params = trained
        perturb(atlas)
        rot0, tr0 = pose_errors(atlas, ds)
        t1 = time.perf_counter()
        info = run(method, atlas, ds)
        seconds = time.perf_counter() - t1
        rot1, tr1 = pose_errors(atlas, ds)
        out[method] = dict(rot_rmse_deg_before=rot0, trans_rmse_m_before=tr0,
                           rot_rmse_deg_after=rot1, trans_rmse_m_after=tr1, seconds=seconds,
                           **info)
        print(f"{method}: {rot0:.4f} deg / {100 * tr0:.3f} cm -> {rot1!r} deg / "
              f"{tr1!r} m in {seconds:.1f} s {info}", flush=True)
    out["total_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
