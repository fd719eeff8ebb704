"""The device-only trace: its window lies between the end of the first
marker kernel and the start of the second; the launches a step are counted
inside it, and the device's idle share is its busy time a step against the
untraced window's time a step."""
from __future__ import annotations

import json

import pytest

from portbench.harness import cell as cells, trace


def _op(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_device_trace_reads_between_its_markers(tmp_path):
    events = [_op("warm_up", 0, 5), _op("at::cuda::spin_kernel(long)", 10, 2),
              _op("a", 14, 4), _op("b", 16, 4), _op("Memset (Device)", 30, 2, "gpu_memset"),
              _op("at::cuda::spin_kernel(long)", 40, 2), _op("after", 45, 3)]
    tr = trace._parse_device(_write(tmp_path, events), steps=2)
    assert tr.window_s == pytest.approx(28e-6)          # 12 us to 40 us
    assert tr.busy_s == pytest.approx(8e-6)             # [14, 20] and [30, 32]
    ctx = {"device_trace": tr, "counts": {}, "step_s": 10e-6}
    assert cells.reader("device_idle.map")(ctx) == pytest.approx(100.0 * (1 - 4 / 10))
    assert cells.reader("map_step_launches")(ctx) == pytest.approx(1.0)   # a and b, 2 steps


def test_device_trace_without_two_markers_is_refused(tmp_path):
    events = [_op("at::cuda::spin_kernel(long)", 10, 2), _op("a", 14, 4)]
    with pytest.raises(RuntimeError, match="markers"):
        trace._parse_device(_write(tmp_path, events), steps=1)


def test_readers_without_a_device_trace_return_nothing():
    for name in ("device_idle.map", "map_step_launches"):
        assert cells.reader(name)({"counts": {}, "step_s": 1.0}) is None
