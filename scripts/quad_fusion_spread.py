#!/usr/bin/env python3
"""Run-to-run spread of chip_smoke.py phase 6's ATE before fusion, after the
Fuser's alignment and after its fuse, on one CUDA card.

    python3 scripts/quad_fusion_spread.py [--online N] [--repeats M] [--out FILE]

Runs phase 6's two-submap quad SLAM (chip_smoke.quad_setup, the pretrained
decoder, System on a GridAtlas) N times (default 3), and after each run the
Fuser (chip_smoke.fuse_quad: the demo's alignment overrides, 30 fuse steps
of 2^19 points) M times (default 2), each on its own copy of the atlas.  The
spread between the copies of one run is the Fuser's own; the spread between
runs adds the online run's (float atomics in the kernels' backward make the
trajectory before fusion differ from run to run).  Phase 6's gates are
recorded, not raised.  Prints one line per Fuser run and, last, a JSON
object with every reading and the card's name and power limit.
"""
import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--online", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quad_fusion_spread: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from miso_tpu_torch.utils.eval import trajectory_error

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)

    cs.check = record
    counters = cs.kernel_counters()
    dev = torch.device("cuda")
    runs = []
    for i in range(args.online):
        mesh, _, ds_track, ds_map, cfg, _ = cs.quad_setup()
        decoder = cs.pretrain_decoder(mesh, cfg["model"], dev, trunc_dist=0.5)
        cfg["model"]["decoder"]["fix"] = True
        _, T_est, _, atlas = cs.run_online(cfg, ds_track, counters, final_iters=0,
                                           ds_map=ds_map, R0=np.eye(3, dtype=np.float32),
                                           label=f"quad run {i}", decoder=decoder)
        T_gt = np.stack([cs._pose(*ds_track.true_kf_pose_in_world(k))
                         for k in range(ds_track.num_kfs)])
        ate = trajectory_error(T_est, T_gt, align=True)
        fuses = []
        for j in range(args.repeats):
            rep = cs.fuse_quad(copy.deepcopy(atlas), ds_map, ds_track, cfg, counters, T_gt,
                               ate, card)
            fuses.append(dict(postalign_cm=100 * rep["ate_postalign"]["ate_rmse"],
                              postfuse_cm=100 * rep["ate_postfuse"]["ate_rmse"],
                              align_s=rep["align_s"], fuse_s=rep["fuse_s"]))
            print(f"run {i} fuse {j}: ATE {100 * ate['ate_rmse']:.3f} -> "
                  f"{fuses[-1]['postalign_cm']:.3f} -> {fuses[-1]['postfuse_cm']:.3f} cm",
                  flush=True)
        runs.append(dict(prefusion_cm=100 * ate["ate_rmse"], fuses=fuses))
        del atlas
        torch.cuda.empty_cache()
    out = dict(card=card, runs=runs, gate_failures=failures,
               jax_cpu_cm=dict(prefusion=100 * cs.JAX_QUAD_ATE_M,
                               postalign=100 * cs.JAX_QUAD_POSTALIGN_ATE_M,
                               postfuse=100 * cs.JAX_QUAD_POSTFUSE_ATE_M))
    for key in ("postalign_cm", "postfuse_cm"):
        v = np.array([f[key] for r in runs for f in r["fuses"]])
        out[key] = dict(min=float(v.min()), max=float(v.max()), mean=float(v.mean()),
                        std=float(v.std(ddof=1)) if len(v) > 1 else 0.0)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
