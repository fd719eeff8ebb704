#!/usr/bin/env python3
"""Hold every bf16 table path of the interp and fused kernels to its plain
version on one CUDA card, and time each against the same call on float32.

    python3 scripts/bf16_kernels.py [--out FILE]

Builds the kernels from this checkout's sources, then runs
``chip_smoke.phase_bf16_kernels`` (``chip_smoke.py`` phase 10 (a)): the
interp forward and its three backward modes, single-grid (staged, paired and L2
paths, padded storage with logical sizes, F = 1, 3, 4, 12, 0 and 1 points)
and slot-id (``chip_smoke.SLOT_CASES``), and the fused kernel at the ScanNet
widths with 1e6 points; a float16 table and mixed levels refused; then bf16
and float32 times in turns at the ScanNet levels (call and device ms, bound
at each table's element size, the plain version, ``grid_sample`` on the bf16
volume).  Prints the card's name and power limit, then one JSON line (also
written to ``--out``).  Imports torch and this checkout's chip_smoke and
package.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from miso_tpu_torch.ops import _build
    card = chip_smoke.card_line()
    print(card, flush=True)
    seconds = _build.build_all()
    print("nvcc seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    errs, times = chip_smoke.phase_bf16_kernels()
    result = {"card": card, "max_abs_err": errs, "times": times}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
