"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything it is
made of is found by name (``portbench/harness/cell.py``).  Set-up builds the
program's state from the seed and warms up every shape the traffic uses;
the window then runs for ``--seconds``.  With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from
a device trace taken after the window.  After the window the program's state
is freed and the plain reference decides ``correct``; each number compared is
printed beside its limit, last on standard error and last in the line.

It measures ``miso_tpu_torch`` only.  Without a card, or with fewer cards than
the cell asks for, it exits 3 and prints no result; if ``jax``, ``jaxlib``,
``flax`` or ``miso_tpu`` has been imported by the time the result is due, it
exits 4 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "miso_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the run must not hold, compared
    whole (``miso_tpu_torch`` is not ``miso_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, seconds: float, trace: bool, t_start: float):
    """Set up, measure, trace, free and check one cell.  Returns the result
    dict (without its checks) and the checks [(name, value, limit)]."""
    import torch
    from portbench.harness import cell as cells, trace as tracing

    dev = cell.device
    runner = cells.runner_class(cell.traffic["runner"])(cell)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    runner.setup()
    setup_s = time.perf_counter() - t_start
    win = runner.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = runner.trace() if trace else None
    runner.release()
    checks = runner.check()
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(math.isfinite(v) and v <= lim for _, v, lim in checks),
              "attempted": int(win["attempted"]), "failed": int(win["failed"])}
    if trace:
        ctx["cell"] = cell
        result["metrics"] = cells.read_metrics(cell, ctx)
        device.update(tracing.device_fields(ctx.get("device_trace") or ctx["trace"]))
        result["device"] = device
        result["breakdown"] = tracing.breakdown(ctx["trace"], ctx.get("device_trace"))
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end()}
        result["device"] = device
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import cell as cells
    bench = cells.bench_json()
    workload = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if workload is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"the cell needs {workload['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = cells.load(bench, args.workload, args.seed, torch.device("cuda", 0))
    result, checks = run_cell(cell, args.seconds, bool(args.trace), T_START)
    result["device"]["power_limit_w"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures miso_tpu_torch alone",
              file=sys.stderr)
        return 4
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
