#!/usr/bin/env python3
"""Run-to-run spread of chip_smoke.py phase 7 on one CUDA card.

    python3 scripts/align_spread.py [--runs N] [--out FILE]

Builds the kernels once, then runs phase 7 (chip_smoke.phase_align: the
atlas built anew, the MISO alignment, then the vfpp, mips, icp and InfoNCE
runs) N times (default 3) in one process, with every gate of the phase
recorded rather than raised.  Prints each run's rotation (deg) and
translation (cm) RMSE after each method and seconds, then per method the
mean, the standard deviation and how many of them each limit sits from the
mean (the limits of chip_smoke.py: the JAX CPU run's reading plus or minus
the margin, and for vfpp and mips a third of the perturbation, for icp the
perturbation), and writes the readings as JSON to ``--out``.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

METHODS = ("miso", "vfpp", "mips", "icp", "infonce")


def limits(chip_smoke, method):
    """(rotation limits (lo, hi) deg, translation limits (lo, hi) m)."""
    if method == "miso":
        jr, jt = chip_smoke.JAX_ALIGN_ROT_DEG, chip_smoke.JAX_ALIGN_TRANS_M
        mr, mt = chip_smoke.ALIGN_ROT_MARGIN_DEG, chip_smoke.ALIGN_TRANS_MARGIN_M
    else:
        jr, jt = chip_smoke.JAX_ALIGN_AFTER[method]
        mr, mt = chip_smoke.BASELINE_MARGINS[method]
    top = {"miso": 1 / 3, "vfpp": 1 / 3, "mips": 1 / 3, "icp": 1.0}.get(method, np.inf)
    return ((max(jr - mr, 0.0), min(jr + mr, top * chip_smoke.ALIGN_NOISE_DEG)),
            (max(jt - mt, 0.0), min(jt + mt, top * chip_smoke.ALIGN_NOISE_M)))


def main() -> int:
    if not torch.cuda.is_available():
        print("align_spread: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke
    from miso_tpu_torch import native
    from miso_tpu_torch.ops import _build
    from miso_tpu_torch.ops.fused_decode import _library
    from miso_tpu_torch.ops.tiled_interp import _library as interp_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    _library()
    _library("mlp_decode")
    interp_library()
    native.build()
    card = chip_smoke.card_line()
    print(card, flush=True)
    missed = []
    chip_smoke.check = lambda cond, msg: None if cond else missed.append(msg)
    runs = []
    for i in range(args.runs):
        report, _ = chip_smoke.phase_align(card)
        row = {"miso": (report["rot_rmse_deg_after"], report["trans_rmse_m_after"],
                        report["align_s"])}
        for m, r in report["baselines"].items():
            row[m] = (r["rot_rmse_deg_after"], r["trans_rmse_m_after"], r["seconds"])
        runs.append(row)
        print(f"run {i}: " + "; ".join(f"{m} {v[0]:.4f} deg / {100 * v[1]:.3f} cm in {v[2]:.2f} s"
                                       for m, v in row.items()), flush=True)
    summary = {}
    for m in METHODS:
        a = np.array([r[m] for r in runs])
        mean, sd = a.mean(0), a.std(0, ddof=1) if len(a) > 1 else np.zeros(3)
        (rlo, rhi), (tlo, thi) = limits(chip_smoke, m)
        sds = [float(min(mean[0] - rlo, rhi - mean[0]) / max(sd[0], 1e-12)),
               float(min(mean[1] - tlo, thi - mean[1]) / max(sd[1], 1e-12))]
        summary[m] = dict(rot_deg=a[:, 0].tolist(), trans_m=a[:, 1].tolist(),
                          seconds=a[:, 2].tolist(), mean=mean.tolist(), sd=sd.tolist(),
                          limits_deg=(rlo, rhi), limits_m=(tlo, thi), limit_sds=sds)
        print(f"{m}: rotation {mean[0]:.4f} +- {sd[0]:.4f} deg (limits {rlo:.4f}-{rhi:.4f}, "
              f"{sds[0]:.1f} s.d. away), translation {100 * mean[1]:.3f} +- {100 * sd[1]:.3f} cm "
              f"(limits {100 * tlo:.3f}-{100 * thi:.3f}, {sds[1]:.1f} s.d. away)", flush=True)
    out = {"card": card, "runs": runs, "summary": summary, "missed_gates": missed}
    print(f"gates missed: {missed}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
