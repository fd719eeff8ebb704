#!/usr/bin/env python3
"""Time the interp kernels of one checkout's miso_tpu_torch on one CUDA card.

    python3 scripts/interp_grad_times.py [--root DIR] [--label NAME] [--calls N]

``--root`` (default: this checkout) is the checkout whose package is timed,
so that another commit unpacked beside this one is timed by the same script
in the same call; ``--label`` names it in the output.

Shapes: ``chip_smoke.INTERP_SHAPES``, where the paths call the interp
kernels: bench.py's default-decode mapping step at the ScanNet levels,
105x88x31x4 and 21x18x7x4, with 1e6 points; the synthetic mesh path at
50x50x27x4 and 10x10x6x4 with 2^15-point batches.  Grids and points are
drawn by ``chip_smoke._grid_case`` (uniform in the bound, 5 % pushed
outside), the cotangent from a normal.  For each shape:

  * ``fwd``: the forward wrapper's call;
  * ``grad``: the grad wrapper, table only (``need_x=False``);
  * ``grad_x``: the grad wrapper with the points' gradient, as the mapping
    step calls it (its coordinates carry the poses' gradient).

``call_ms`` is the mean per call by CUDA events over N back-to-back calls
(what a caller waits for: the host's launch cost shows when it is the
larger); ``device_ms`` the device time per call summed over every kernel
and memset the call ran (``chip_smoke._device_events``).  Prints the card's
name and power limit, then one JSON line.  Imports torch, this checkout's
chip_smoke and the package at ``--root``.
"""
import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interp_grad_times: needs a CUDA card", file=sys.stderr)
        return 1
    # This checkout's shapes and timing helpers, the package at --root.
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from miso_tpu_torch.ops.tiled_interp import (grid_interpolate_cuda,
                                                 grid_interpolate_grad_cuda)
    print(chip_smoke.card_line(), flush=True)
    out = {"label": args.label, "root": args.root, "shapes": {}}
    for seed, (name, bound_list, cell, n) in enumerate(chip_smoke.INTERP_SHAPES):
        grid, x, bound = chip_smoke._grid_case(bound_list, cell, 4, n, seed)
        cot = torch.randn((n, 4), generator=torch.Generator(device=x.device).manual_seed(seed),
                          device=x.device)
        fns = {"fwd": lambda: grid_interpolate_cuda(grid, x, bound),
               "grad": lambda: grid_interpolate_grad_cuda(grid, x, bound, cot,
                                                          need_x=False),
               "grad_x": lambda: grid_interpolate_grad_cuda(grid, x, bound, cot)}
        rec = {}
        for key, fn in fns.items():
            events = chip_smoke._device_events(fn, args.calls)
            rec[key] = {"call_ms": chip_smoke.cuda_ms(fn, calls=args.calls),
                        "device_ms": sum(us for _, us in events) / args.calls / 1e3,
                        "device_ops_per_call": len(events) / args.calls}
        out["shapes"][name] = rec
        print(f"  {args.label} {name} {tuple(grid.shape)} x {n}: " + ", ".join(
            f"{k} call {v['call_ms']:.4f} ms, device {v['device_ms']:.4f} ms"
            for k, v in rec.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
