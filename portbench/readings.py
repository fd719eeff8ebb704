"""Readings that a cell's output limits are set from, over many seeds in one
process: each seed's program run (set-up and the steps the check follows)
against the reference, the control (the reference in TF32 in the program's
place) against it, and each planted fault (the runner's ``FAULTS``) against
it.

    python3 portbench/readings.py --workload ncd_quad.map_step --seeds 1 2 3 \\
        [--control 3] [--faults 3] [--detail] [--out readings.jsonl]

A training cell's readings need no window.  One JSON line a reading,
printed and, with ``--out``, appended to a file.  Runs on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def run_seed(cells, bench, workload, seed, dev, fault=None):
    """(runner, program readings) of one seed, with ``fault`` planted."""
    cell = cells.load(bench, workload, seed, dev)
    kind = cell.traffic["runner"]
    with cells.planted(kind, fault) if fault else contextlib.nullcontext():
        r = cells.runner_class(kind)(cell)
        r.setup()
        r.release()
    return r, r.program_readings()


def _plain(readings):
    """The JSON-able numbers of a runner's readings (tensors left out)."""
    if isinstance(readings, dict):
        return {k: _plain(v) for k, v in readings.items()}
    if isinstance(readings, (list, tuple)):
        return [_plain(v) for v in readings]
    return readings if isinstance(readings, (int, float, str)) or readings is None else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0, help="seeds (the first N) with the control")
    p.add_argument("--faults", type=int, default=0, help="seeds (the first N) with each fault")
    p.add_argument("--detail", action="store_true",
                   help="also each checked solve's readings, and the reference against "
                        "a second run of itself (its own summation-order noise)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    from portbench.harness import cell as cells

    dev = torch.device("cuda")
    bench = cells.bench_json()
    out = open(args.out, "a") if args.out else None
    kind = cells.load(bench, args.workload, 0, dev).traffic["runner"]

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r, got = run_seed(cells, bench, args.workload, seed, dev)
        ref = r.reference_readings("fp32")
        emit({"workload": args.workload, "seed": seed, "side": "program", **r.compare(got, ref),
              "s": time.perf_counter() - t0})
        if args.detail:
            ref2 = r.reference_readings("fp32")
            emit({"workload": args.workload, "seed": seed, "side": "reference_again",
                  **r.compare(ref2, ref)})
            emit({"workload": args.workload, "seed": seed, "side": "detail",
                  "program": _plain(got), "reference": _plain(ref), "reference_again": _plain(ref2)})
        if i < args.control:
            emit({"workload": args.workload, "seed": seed, "side": "control_tf32",
                  **r.compare(r.reference_readings("tf32"), ref)})
        if i < args.faults:
            for name in cells.runner_module(kind).FAULTS:
                f, fgot = run_seed(cells, bench, args.workload, seed, dev, name)
                emit({"workload": args.workload, "seed": seed, "side": f"fault_{name}",
                      **f.compare(fgot, f.reference_readings("fp32"))})
                del f
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
