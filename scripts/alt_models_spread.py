#!/usr/bin/env python3
"""Spread of chip_smoke.py phase 9's readings over the models' random draws,
on one CUDA card.

    python3 scripts/alt_models_spread.py [--seeds 0 1 2] [--models isdf ngp pointsdf vm grid2d]
                                         [--out FILE]

Builds the kernels once, then for each seed runs phase 9's parts
(chip_smoke.alt_models_3d for the 3D models, chip_smoke.alt_grid_2d for the
2D grid) with the models drawn from that seed, every gate recorded rather
than raised.  Prints each run's F-score (%) and Chamfer_L1 (cm), or the 2D
grid's MAE (m), then per model the mean and standard deviation beside the
JAX package's CPU run (chip_smoke.JAX_ALT*), and writes the readings and the
missed gates as JSON to ``--out``.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("alt_models_spread: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2])
    ap.add_argument("--models", nargs="*", default=list(chip_smoke.ALT_MODELS) + ["grid2d"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from miso_tpu_torch import native
    from miso_tpu_torch.datasets.sdf_3d import Sdf3D
    from miso_tpu_torch.datasets.shapes import room_scene
    from miso_tpu_torch.native import TriangleMesh
    from miso_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    native.build()
    card = chip_smoke.card_line()
    print(card, flush=True)
    missed = []
    chip_smoke.check = lambda cond, msg: None if cond else missed.append(msg)
    counters = chip_smoke.kernel_counters()
    scene = TriangleMesh(*room_scene(4.0))
    ds = Sdf3D(scene, batch_size=chip_smoke.MESH_BATCH, total_samples=chip_smoke.MESH_SAMPLES,
               trunc_dist=0.3)
    models3d = [m for m in args.models if m != "grid2d"]
    readings = {m: [] for m in args.models}
    for seed in args.seeds:
        for name, r in chip_smoke.alt_models_3d(scene, ds, counters, card, models=models3d,
                                                seed=seed).items():
            m = r["mesh"]["metrics"]
            readings[name].append((m["F-score (%)"], m["Chamfer_L1 (cm)"]))
        if "grid2d" in args.models:
            readings["grid2d"].append((chip_smoke.alt_grid_2d(counters, card, seed=seed)["mae"],))
    summary = {}
    for name, rows in readings.items():
        a = np.array(rows)
        mean, sd = a.mean(0), a.std(0, ddof=1) if len(a) > 1 else np.zeros(a.shape[1])
        ref = (chip_smoke.JAX_ALT_2D_MAE,) if name == "grid2d" else chip_smoke.JAX_ALT[name]
        summary[name] = dict(readings=a.tolist(), mean=mean.tolist(), sd=sd.tolist(), jax_cpu=ref)
        print(f"{name}: " + ", ".join(f"{v:.4f} +- {d:.4f} (JAX CPU {r:.4f})"
                                      for v, d, r in zip(mean, sd, ref))
              + f" over seeds {args.seeds}: {a.tolist()}", flush=True)
    print(f"gates missed: {missed}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "seeds": args.seeds, "summary": summary,
                       "missed_gates": missed}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
