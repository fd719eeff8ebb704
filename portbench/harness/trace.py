"""Device traces of a few steps and what the per-layer readers take from it.

``capture`` runs ``fn(k)`` under ``torch.profiler`` (CPU and CUDA): first
two untimed calls, since the profiler has been seen to miss a window's first
kernels, then the traced window, a ``record_function`` span that ends with a
synchronize, so that every kernel the window launched lies inside it.
``Trace`` holds the window's device operations, each with the names of the
CPU operations that enclosed its launch, so that a reader can pick a layer's
work by kernel name or by autograd node.  Recording every CPU operation
slows the host's launches, so the device's busy time and the launch count
come from ``capture_device`` instead: the same calls traced on the device
alone, the window framed by two marker kernels (``torch.cuda._sleep``), from
the end of the first to the start of the second.  Tracing the device alone
still slows the launches, so the idle share sets that busy time against
the untraced window (``metrics/device_idle.map.py``).  Each Chrome trace is
written to a temporary directory under ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

WINDOW = "portbench_traced_window"
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000


class DeviceOp:
    __slots__ = ("name", "cat", "ts", "dur", "scopes")

    def __init__(self, name, cat, ts, dur, scopes):
        self.name, self.cat, self.ts, self.dur, self.scopes = name, cat, ts, dur, scopes

    def in_scope(self, fragment: str) -> bool:
        return any(fragment in s for s in self.scopes)


class Trace:
    """Device operations of the traced window (microseconds), the window's
    span, and the CPU operations of every thread for naming idle gaps."""

    def __init__(self, ops: List[DeviceOp], t0: float, t1: float, host_ops, steps: int):
        self.ops, self.t0, self.t1, self.steps = ops, t0, t1, steps
        self.host_ops = host_ops  # (ts, end, name), sorted by start

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the window."""
        iv = sorted((max(o.ts, self.t0), min(o.ts + o.dur, self.t1)) for o in self.ops)
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def seconds(self, pick: Callable[[DeviceOp], bool]) -> float:
        return sum(o.dur for o in self.ops if pick(o)) * 1e-6

    def count(self, pick: Callable[[DeviceOp], bool]) -> int:
        return sum(1 for o in self.ops if pick(o))

    def top_ops(self, k: int = 10):
        per = defaultdict(float)
        for o in self.ops:
            per[o.name] += o.dur * 1e-6
        return sorted(([n, s] for n, s in per.items()), key=lambda v: -v[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle time by what the host was doing when each gap began: the
        latest-started CPU operation open there, summed over gaps."""
        per = defaultdict(float)
        starts = [h[0] for h in self.host_ops]
        prev = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                per[self._host_at(prev, starts)] += (a - prev) * 1e-6
            prev = max(prev, b)
        return sorted(([n, s] for n, s in per.items()), key=lambda v: -v[1])[:k]

    def _host_at(self, ts, starts):
        i = bisect.bisect_right(starts, ts)
        for j in range(i - 1, max(i - 300, -1), -1):
            h = self.host_ops[j]
            if h[0] <= ts < h[1]:
                return h[2]
        return "host (no operation open)"


def _enclosing(cpu, launch):
    """correlation -> names of the CPU operations open on the launching
    thread when the launch was made (outermost first).  Operations on one
    thread nest, so one sweep in time order with a stack finds them."""
    by_tid = defaultdict(list)
    for corr, (tid, ts) in launch.items():
        by_tid[tid].append((ts, corr))
    out = {}
    for tid, calls in by_tid.items():
        ops, stack, j = cpu.get(tid, []), [], 0
        for ts, corr in sorted(calls):
            while j < len(ops) and ops[j][0] <= ts:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = tuple(o[2] for o in stack if o[1] >= ts)
    return out


def _parse(path: str, steps: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    w = window[-1]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    cpu = defaultdict(list)      # tid -> [(ts, end, name)]
    launch = {}                  # correlation -> (tid, ts)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch[args["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat in ("cpu_op", "user_annotation"):
            ts = float(e["ts"])
            cpu[e.get("tid")].append((ts, ts + float(e.get("dur", 0)), e.get("name", "")))
    for v in cpu.values():
        v.sort(key=lambda c: (c[0], -c[1]))
    scopes = _enclosing(cpu, launch)
    ops = []
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur <= t0 or ts >= t1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ops.append(DeviceOp(e.get("name", ""), e.get("cat", ""), ts, dur, scopes.get(corr, ())))
    host = sorted((c for v in cpu.values() for c in v
                   if c[1] > t0 and c[0] < t1 and c[2] != WINDOW),
                  key=lambda c: (c[0], -c[1]))
    return Trace(ops, t0, t1, host, steps)


def _parse_device(path: str, steps: int) -> Trace:
    """The device operations between the two marker kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    marks = [e for e in device if MARKER in e.get("name", "")]
    if len(marks) != 2:
        raise RuntimeError(f"the device trace has {len(marks)} {MARKER!r} markers, not 2")
    t0 = float(marks[0]["ts"]) + float(marks[0].get("dur", 0))
    t1 = float(marks[1]["ts"])
    ops = [DeviceOp(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
                    float(e.get("dur", 0)), ()) for e in device
           if MARKER not in e.get("name", "") and t0 <= float(e["ts"]) < t1]
    return Trace(ops, t0, t1, [], steps)


def _export(prof, parse, steps: int, tmp_root: Optional[str]) -> Trace:
    tmp = tempfile.mkdtemp(prefix="portbench_trace_", dir=tmp_root)
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path, steps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def capture(fn: Callable[[int], None], steps: int, tmp_root: Optional[str] = None) -> Trace:
    """Trace ``fn(steps)``, CPU operations and device, after two untraced
    calls ``fn(1)`` inside the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(1)
        fn(1)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn(steps)
            torch.cuda.synchronize()
    return _export(prof, _parse, steps, tmp_root)


def capture_device(fn: Callable[[int], None], steps: int,
                   tmp_root: Optional[str] = None) -> Trace:
    """Trace ``fn(steps)`` on the device alone, between two marker kernels,
    after two untraced calls ``fn(1)`` inside the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(1)
        fn(1)
        torch.cuda.synchronize()
        torch.cuda._sleep(MARKER_CYCLES)
        fn(steps)
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    return _export(prof, _parse_device, steps, tmp_root)


def device_fields(tr: Trace) -> Dict[str, float]:
    return {"busy_s": tr.busy_s, "window_s": tr.window_s}


def breakdown(tr: Trace, device: Optional[Trace] = None) -> Dict[str, list]:
    """The top device operations (from the device-only trace where there is
    one) and the longest idle gaps by what the host was doing."""
    return {"device_ops": (device or tr).top_ops(10), "idle_gaps": tr.idle_gaps(10)}
