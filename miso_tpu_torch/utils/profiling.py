"""Timing and profiling (port of ``miso_tpu/utils/profiling.py``).

The program's spans (:func:`span`), the SLAM loop's per-frame stage
breakdown, and a ``torch.profiler`` trace context with the per-step kernel
and operator tables read from it.

Spans.  ``span(name)`` marks a phase of the program for whatever profiler is
recording: a ``torch.profiler.record_function``, which lands in the trace as
a ``user_annotation`` event on the profiler's clock, beside the kernels,
memsets and copies it launched.  With no profiler recording it returns one
shared no-op context: one flag check, nothing allocated, formatted or
recorded.  The names and the thread each opens on:

  ``miso.step``, ``.loss``, ``.grad``, ``.update``
      ``train/trainer.py::make_train_step``'s step, its loss, its
      ``autograd.grad`` and its NaN-guarded optimizer update of the trained
      leaves (caller's thread).  A CUDA backward runs on PyTorch's
      autograd worker thread: its kernels lie in ``miso.step.grad`` by
      time, not by scope.
  ``miso.align``, ``.precompute``, ``.intersect``, ``.ctx``, ``.steps``
      ``align/miso.py::align_multiple_submaps_hierarchical``'s call, its
      selection of the alignment coordinates, its pair tests, and each
      level's pair context and step loop (the ``miso.step`` spans inside),
      each closed after the synchronize that ends its work (caller's
      thread).
  ``miso.launch.<kernel>``
      each kernel launcher of ``ops/tiled_interp.py`` and
      ``ops/fused_decode.py``, at its ``.launches`` counter: the
      launcher's checks, argument packing and launch (the thread that
      calls it; the interp backward's on the autograd worker thread).
  ``slam.<stage>``
      ``slam/system.py::System.step``'s stages.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the trace of a recording profiler,
    and the shared no-op context when none records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def synchronize(target: Any = None):
    """Wait for the card's queued work: a no-op for CPU tensors; ``target``
    is a tensor (its device), a device, or None (every CUDA device in use)."""
    if not torch.cuda.is_available():
        return
    if isinstance(target, torch.Tensor):
        if target.is_cuda:
            torch.cuda.synchronize(target.device)
        return
    if isinstance(target, torch.device):
        if target.type == "cuda":
            torch.cuda.synchronize(target)
        return
    torch.cuda.synchronize()


class StageProfiler:
    """Per-frame, per-stage wall-clock breakdown of the SLAM loop.

    Each frame accumulates named stage durations; a stage waits for its
    ``sync`` target (a tensor, a device, or a callable returning one) before
    it reads the clock.  ``summary()`` reports each stage's median, mean and
    p90 over frames, and the frame's total (``*_sample`` host-sampling
    entries excluded: they lie inside their stages).
    """

    def __init__(self):
        self.frames = []
        self._cur: Optional[Dict] = None

    def start_frame(self, frame: int):
        self._cur = {"frame": frame}

    def add(self, name: str, dt: float):
        if self._cur is not None:
            self._cur[name] = self._cur.get(name, 0.0) + dt

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        if self._cur is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync() if callable(sync) else sync)
            self.add(name, time.perf_counter() - t0)

    def mark(self, name: str):
        if self._cur is not None:
            self._cur[name] = True

    def end_frame(self):
        if self._cur is not None:
            self.frames.append(self._cur)
            self._cur = None

    def summary(self) -> Dict:
        keys = set()
        for f in self.frames:
            keys.update(k for k, v in f.items() if k != "frame" and isinstance(v, float))
        out: Dict = {"n_frames": len(self.frames)}
        totals = [sum(v for k, v in f.items() if k != "frame" and isinstance(v, float)
                      and not k.endswith("_sample")) for f in self.frames]
        if totals:
            out["frame_ms"] = _stats(totals)
        for k in sorted(keys):
            out[k + "_ms"] = _stats([f.get(k, 0.0) for f in self.frames])
        return out


def _stats(seconds):
    ms = 1e3 * np.asarray(seconds, np.float64)
    return {"median": float(np.median(ms)), "mean": float(np.mean(ms)),
            "p90": float(np.percentile(ms, 90))}


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card; with ``log_dir`` also written there as a Chrome trace
    (``trace.json``).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals: time in which at
    least one of them ran, overlaps counted once."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def breakdown(label: str, run, steps: int, top: int = 25) -> Dict:
    """Time ``run(steps)`` unprofiled, then under :func:`device_trace`, and
    print the card's kernels and the aten operators by device time per step.
    The idle share is the part of the unprofiled window in which no kernel,
    memset or copy ran: one minus the union of their intervals in the
    profiled window (overlapping kernels counted once) over the unprofiled
    window.  Returns the step's wall ms (unprofiled and profiled), device ms
    (summed over kernels), busy ms (their union), idle share and its three
    largest kernels (name, device ms per step, share of the device time)."""
    t0 = time.perf_counter()
    run(steps)
    synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with device_trace() as prof:
        t0 = time.perf_counter()
        run(steps)
        synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    per_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        # A span's device-side copy (``gpu_user_annotation``) is no work.
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            rec = per_name[e.name]
            rec[0] += e.time_range.elapsed_us() / 1e3 / steps
            rec[1] += 1
            intervals.append((e.time_range.start, e.time_range.end))
    device_ms = sum(v[0] for v in per_name.values())
    busy_ms = busy_us(intervals) / 1e3 / steps
    idle = max(0.0, 1.0 - busy_ms / plain_wall_ms)
    print(f"== {label}: {steps} steps; wall {plain_wall_ms:.3f} ms/step unprofiled, "
          f"{wall_ms:.3f} profiled (host clock); device {device_ms:.3f} ms/step "
          f"summed over kernels, {busy_ms:.3f} busy; idle share {idle:.3f} of the "
          f"unprofiled window")
    print(f"{'ms/step':>9} {'share':>6} {'calls/step':>10}  kernel")
    for name, (ms, calls) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{ms:9.4f} {ms / device_ms:6.3f} {calls / steps:10.1f}  {name[:110]}")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print(f"{'ms/step':>9} {'calls/step':>10}  operator (self device time)")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{e.self_device_time_total / 1e3 / steps:9.4f} {e.count / steps:10.1f}  "
              f"{e.key}")
    largest = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:3]
    return dict(wall_ms=plain_wall_ms, profiled_wall_ms=wall_ms, device_ms=device_ms,
                busy_ms=busy_ms, idle_share=idle, steps=steps,
                top_kernels=[dict(name=name, ms=ms, share=ms / device_ms)
                             for name, (ms, _) in largest])
