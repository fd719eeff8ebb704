#!/usr/bin/env python3
"""The spread of ``chip_smoke.py`` phase 10 (b)'s bf16 training reading over
initial draws, in the port: ``tests/test_train_e2e.py::test_bf16_features``'s
recipe (an icosphere, ``grid.feature_dtype: bfloat16``, 150 epochs) from
each key's draws, and its SDF MAE on a fresh batch.

    python3 scripts/bf16_recipe_spread.py [--device cuda|cpu] [--keys 0 1 ...]
        [--own_draws] [--bf16_scatter] [--out FILE]

By default each key's draws are ``chip_smoke.alt_draws(key)``, the numpy
draws that ``scripts/jax_apps.py --bf16_keys`` gives the JAX package; with
``--own_draws`` the port's own initializer seeded with the key.  On
``cuda`` the training runs the interp and decode kernels on the card, on
``cpu`` their plain versions.  ``--bf16_scatter`` (``cpu`` only) makes the
plain forward gather the bf16 rows without widening the table first, so that
autograd sums the table's gradient in bf16, rounding at every add, as the
JAX package's scatter-add does, instead of in float32 rounded once.  Prints each key's MAE, their mean and
standard deviation, and writes them as JSON to ``--out``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keys", nargs="*", type=int, default=list(range(8)))
    ap.add_argument("--own_draws", action="store_true")
    ap.add_argument("--bf16_scatter", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.bf16_scatter:
        if args.device != "cpu":
            ap.error("--bf16_scatter changes the plain version: --device cpu")
        from miso_tpu_torch.ops import interp, tiled_interp
        tiled_interp.grid_interpolate_plain = (
            lambda grid, x, bound, size=None: interp.grid_interpolate(grid, x, bound, size))
    maes = {}
    for key in args.keys:
        t0 = time.time()
        ds, trainer = cs.apps_bf16_setup(key, args.own_draws, args.device)
        maes[key] = cs.apps_bf16_mae(trainer.train(), ds)
        print(f"key {key}: MAE {maes[key]:.6f} ({time.time() - t0:.1f} s)", flush=True)
    v = np.array(list(maes.values()))
    out = {"device": args.device, "own_draws": args.own_draws,
           "bf16_scatter": args.bf16_scatter, "mae": maes,
           "mean": float(v.mean()), "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0}
    if args.device == "cuda":
        out["card"] = cs.card_line()
    print(f"{'own' if args.own_draws else 'shared'} draws on {args.device}"
          f"{', bf16 scatter' if args.bf16_scatter else ''}: mean "
          f"{out['mean']:.6f}, s.d. {out['sd']:.6f}, {v.min():.6f}-{v.max():.6f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
