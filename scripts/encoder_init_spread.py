#!/usr/bin/env python3
"""Run-to-run spread of chip_smoke.py phase 8's readings (encoder
initialization) on one CUDA card.

    python3 scripts/encoder_init_spread.py [--demo N] [--system N] [--quad N]
        [--out FILE]

Runs phase 8's parts each the given number of times (default 3, 1, 0):
(a) ``demo/encoder_init.py`` at its defaults from the JAX package's draws
(chip_smoke.encoder_init_demo: the SDF MAE of the zero and the encoder init
after K = 0, 5, 15, 50 optimize_grid_net epochs, the pretrained decoder's
value at zero features, the one-shot encoder ms, the pretraining seconds);
(b) tests/test_encoder_system.py's in-system recipe (the map error of
zero@30, zero@10 and encode@10 init iterations); (c) the quad run with
``--init_mode encode`` (the pre-fusion ATE).  The same seeds every run, so
the spread is the card's (float atomics in the interp backward and the
pooling change sums' order).  Gates are recorded, not raised.  The TF32 flags
stay at PyTorch's defaults (cuDNN's on): the encoder pins its own float32.
Prints each run's readings and, last, a JSON object with every reading and
the card's name and power limit.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _stats(values):
    v = np.asarray(values, np.float64)
    return dict(mean=float(v.mean()), sd=float(v.std(ddof=1)) if len(v) > 1 else 0.0,
                min=float(v.min()), max=float(v.max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", type=int, default=3)
    ap.add_argument("--system", type=int, default=1)
    ap.add_argument("--quad", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encoder_init_spread: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = cs.card_line()
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"  gate missed: {msg}", flush=True)

    cs.check = record
    counters = cs.kernel_counters()
    out = dict(card=card, demo=[], system=[], quad=[])
    for i in range(args.demo):
        r = cs.encoder_init_demo(counters)
        row = {m: r["results"][m]["mae_by_epoch"] for m in ("zero", "encode")}
        row.update(encoder_ms=r["results"]["encode"]["encoder_ms"], pretrain_s=r["pretrain_s"],
                   decoder_s=r["decoder_s"], decoder_at_zero=r["decoder_at_zero"])
        out["demo"].append(row)
        print(f"demo run {i}: {row} ({card})", flush=True)
        for mode in ("zero", "encode"):
            for k, v in row[mode].items():
                ref, tol = cs.enc_mae_limit(mode, k)
                record(abs(v - ref) <= tol, f"demo run {i}: {mode} K={k} MAE {v:.4f} vs "
                       f"JAX CPU {ref:.4f} +- {tol:.4f}")
        record(row["encode"][0] < 0.5 * row["zero"][0], f"demo run {i}: encode K=0 not < half")
    if out["demo"]:
        out["demo_stats"] = {f"{m}_K{k}": _stats([r[m][k] for r in out["demo"]])
                             for m in ("zero", "encode") for k in cs.ENC_EVAL_EPOCHS}
    for i in range(args.system):
        seq, model_cfg, decoder, encoder, setup_s = cs.encoder_system_setup()
        runs, err = cs.encoder_system_runs(seq, model_cfg, decoder, counters, encoder)
        out["system"].append(dict(err=err, setup_s=setup_s,
                                  encoder_ms=runs["encode@10"]["encoder_ms"]))
        print(f"system run {i}: {err} ({card})", flush=True)
        record(err["encode@10"] < 1.15 * err["zero@30"], f"system run {i}: vs zero@30")
        record(err["encode@10"] < 0.9 * err["zero@10"], f"system run {i}: vs zero@10")
    for i in range(args.quad):
        q = cs.phase_quad_encode(card, {"ate_rmse": float("nan"), "rot_rmse_deg": float("nan")})
        out["quad"].append(dict(ate_prefusion=q["ate_prefusion"], encoder_ms=q["encoder_ms"],
                                spawn_ms=q["spawn_parts_ms"],
                                encoder_pretrain_s=q["encoder_pretrain_s"]))
        print(f"quad run {i}: ATE {100 * q['ate_prefusion']['ate_rmse']:.3f} cm ({card})",
              flush=True)
    out["gates_missed"] = failures
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    print(card, flush=True)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
