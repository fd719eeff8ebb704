"""A mapping cell's traced steps read by the program's spans.

    python3 scripts/span_breakdown.py --workload scannet.map_step \\
        [--seed N] [--steps 20] [--root DIR] [--out FILE]

Sets the cell up as ``portbench/run.py`` does, then traces ``--steps``
steps with ``portbench/harness/trace.py::capture`` (CPU operations and the
device) and prints one JSON line:

* ``untraced_ms`` / ``traced_ms``: the host's time a step, untraced and in
  the traced window;
* ``phases``: a step's kernels, other device operations and device ms by
  the innermost ``miso.*`` span open on the launching thread; launches on
  PyTorch's autograd worker thread, which no program span scopes, by their
  autograd node (``backward: <node>``);
* ``idle_gaps``: every idle gap of the window, in ms a step, by the
  latest-started host operation open when it began (``Trace.idle_gaps``,
  which looks back over the last 300 host operations);
* ``idle_by_span``: the same gaps by the innermost ``miso.*`` span open
  when each began, however far back it started (``between steps`` where
  none is), and ``host_ops``: the host operations a step that start inside
  each ``miso.step*`` span;
* ``traced_ms_ab``: the traced window's host time a step, with the spans
  and with every module's ``span`` swapped for the no-op, in turns in this
  process (empty where the program has no ``span``);
* ``span_ns``: what ``utils/profiling.py::span`` costs an enter and exit
  on this host, with no profiler and under one (CPU and CUDA); null where
  the program has no ``span``.

``--root`` runs the program and benchmark of another checkout (one
unpacked beside this one).  Runs on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

NODE_PREFIX = "autograd::engine::evaluate_function: "


def phase_of(op) -> str:
    spans = [s for s in op.scopes if s.startswith("miso.")]
    if spans:
        return spans[-1]
    nodes = [s[len(NODE_PREFIX):] for s in op.scopes if s.startswith(NODE_PREFIX)]
    return f"backward: {nodes[-1]}" if nodes else "(no span)"


def phases(tr):
    per = defaultdict(lambda: {"kernels": 0.0, "other_ops": 0.0, "device_ms": 0.0})
    for o in tr.ops:
        rec = per[phase_of(o)]
        rec["kernels" if o.cat == "kernel" else "other_ops"] += 1.0 / tr.steps
        rec["device_ms"] += 1e-3 * o.dur / tr.steps
    return dict(sorted(per.items(), key=lambda kv: -kv[1]["kernels"]))


def idle_by_span(tr):
    spans = [h for h in tr.host_ops if h[2].startswith("miso.")]
    per = defaultdict(float)
    prev = tr.t0
    for a, b in tr.busy_intervals() + [[tr.t1, tr.t1]]:
        if a > prev:
            open_ = [h for h in spans if h[0] <= prev < h[1]]
            name = max(open_, key=lambda h: h[0])[2] if open_ else "between steps"
            per[name] += 1e-3 * (a - prev) / tr.steps
        prev = max(prev, b)
    return dict(sorted(per.items(), key=lambda kv: -kv[1]))


def host_ops(tr):
    per = defaultdict(float)
    for s0, s1, name in tr.host_ops:
        if name.startswith("miso.step"):
            per[name] += sum(1 for h in tr.host_ops if s0 < h[0] < s1) / tr.steps
    return dict(per)


def traced_ms_ab(tracing, run, k, rounds=3):
    """Traced windows with the spans and with ``span`` swapped for the
    no-op in every module that imported it, in turns."""
    from miso_tpu_torch.utils import profiling
    if not hasattr(profiling, "span"):
        return {}
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("miso_tpu_torch.") and getattr(m, "span", None) is profiling.span]
    real, out = profiling.span, {"spans": [], "no_spans": []}
    for _ in range(rounds):
        for side in ("spans", "no_spans"):
            for m in mods:
                m.span = real if side == "spans" else (lambda name: profiling._NO_SPAN)
            out[side].append(1e3 * tracing.capture(run, k).window_s / k)
    for m in mods:
        m.span = real
    return out


def span_cost_ns(torch):
    from miso_tpu_torch.utils import profiling
    span = getattr(profiling, "span", None)
    if span is None:
        return None

    def loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("miso.step.update"):
                pass
        return 1e9 * (time.perf_counter() - t0) / n

    from torch.profiler import ProfilerActivity, profile
    loop(1000)
    off = loop(200000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        loop(1000)
        on = loop(20000)
    return {"off": off, "on": on}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from portbench.harness import cell as cells, trace as tracing

    dev = torch.device("cuda", 0)
    bench = cells.bench_json(os.path.abspath(args.root))
    cell = cells.load(bench, args.workload, args.seed, dev)
    runner = cells.runner_class(cell.traffic["runner"])(cell)
    runner.setup()
    k = args.steps
    untraced = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner._steps(k)
        torch.cuda.synchronize()
        untraced.append(1e3 * (time.perf_counter() - t0) / k)
    tr = tracing.capture(runner._steps, k)
    ab = traced_ms_ab(tracing, runner._steps, k)
    runner.release()
    out = {"workload": args.workload, "root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "steps": k,
           "untraced_ms": untraced, "traced_ms": 1e3 * tr.window_s / k,
           "busy_ms": 1e3 * tr.busy_s / k, "phases": phases(tr),
           "idle_gaps": [[n, 1e3 * s / k] for n, s in tr.idle_gaps(1000)],
           "idle_by_span": idle_by_span(tr), "host_ops": host_ops(tr), "traced_ms_ab": ab,
           "span_ns": span_cost_ns(torch)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
