"""The readers of the program's spans (``update_device_ms.map``,
``update_launches.map``, ``loss_launches.map``) on synthetic Chrome traces:
each picks the device operations whose launch lay inside its span on the
launching thread, a step's worth, and returns nothing without the span.
The spans leave every other reader's picks as they were, and no span name
in the program holds a fragment an existing reader picks by."""
from __future__ import annotations

import glob
import json
import os
import re

import pytest

from portbench.harness import cell as cells, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAIN, BACKWARD = 1, 2   # the caller's thread and the autograd worker's
STEPS = 2


def _x(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, tid=MAIN, api="cudaLaunchKernel"):
    return _x(api, "cuda_runtime", ts, 2, tid, corr)


def _events(spans: bool):
    """Two steps of 200 us: the loss launches two kernels, the backward
    thread one (inside ``_GridInterpBackward``), the update two kernels and
    a memset; with ``spans`` the program's spans frame each phase."""
    ev = [_x(trace.WINDOW, "user_annotation", 0, 1000)]
    for k in range(STEPS):
        t = 200 * k
        if spans:
            ev += [_x("miso.step", "user_annotation", t + 10, 180),
                   _x("miso.step.loss", "user_annotation", t + 20, 40),
                   _x("miso.step.grad", "user_annotation", t + 70, 40),
                   _x("miso.step.update", "user_annotation", t + 120, 60)]
        c = 10 * k
        ev += [_x("aten::mul", "cpu_op", t + 25, 10), _launch(c + 1, t + 27),
               _launch(c + 2, t + 45),
               _x("autograd::engine::evaluate_function: _GridInterpBackward", "cpu_op",
                  t + 75, 20, BACKWARD),
               _launch(c + 3, t + 80, BACKWARD),
               _launch(c + 4, t + 125), _launch(c + 5, t + 130, api="cudaMemsetAsync"),
               _launch(c + 6, t + 150)]
        ev += [_x("loss_kernel", "kernel", t + 30, 5, 7, c + 1),
               _x("mlp_decode_kernel", "kernel", t + 50, 4, 7, c + 2),
               _x("grid_interp_backward_kernel", "kernel", t + 85, 8, 7, c + 3),
               _x("adam_kernel", "kernel", t + 135, 10, 7, c + 4),
               _x("Memset (Device)", "gpu_memset", t + 146, 2, 7, c + 5),
               _x("adam_kernel", "kernel", t + 155, 6, 7, c + 6)]
    return ev


def _parse(tmp_path, spans: bool):
    path = tmp_path / f"trace_{int(spans)}.json"
    path.write_text(json.dumps({"traceEvents": _events(spans)}))
    return trace._parse(str(path), STEPS)


def test_span_readers_pick_their_phase(tmp_path):
    ctx = {"trace": _parse(tmp_path, spans=True)}
    assert cells.reader("loss_launches.map")(ctx) == pytest.approx(2.0)
    assert cells.reader("update_launches.map")(ctx) == pytest.approx(2.0)
    # Two kernels and the memset: 10 + 2 + 6 us a step.
    assert cells.reader("update_device_ms.map")(ctx) == pytest.approx(0.018)


def test_span_readers_without_their_spans_return_nothing(tmp_path):
    ctx = {"trace": _parse(tmp_path, spans=False)}
    for name in ("loss_launches.map", "update_launches.map", "update_device_ms.map"):
        assert cells.reader(name)(ctx) is None
        assert cells.reader(name)({}) is None


@pytest.mark.parametrize("reader", ["interp_roofline.map", "decode_roofline.map"])
def test_spans_leave_other_readers_picks_alone(tmp_path, reader):
    counts = {"interp_least_s": 1e-6, "decode_least_s": 1e-6}
    got = [cells.reader(reader)({"trace": _parse(tmp_path, s), "counts": counts})
           for s in (False, True)]
    assert got[0] is not None and got[0] == got[1]


def _program_span_names():
    """Every span name the program opens: the literals handed to ``span``
    and the SLAM stages ``slam.<stage>``."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "miso_tpu_torch", "**", "*.py"), recursive=True):
        src = open(path).read()
        names.update(re.findall(r"\bspan\(\"([^\"]+)\"\)", src))
        if re.search(r"span\(\"slam\.\" \+ name\)", src):
            names.update("slam." + s for s in re.findall(r"stage\(\"(\w+)\"\)", src))
    return names


def test_no_span_name_holds_a_readers_fragment():
    names = _program_span_names()
    assert {"miso.step", "miso.step.loss", "miso.step.grad", "miso.step.update",
            "miso.launch.grid_interp", "miso.launch.grid_interp_grad",
            "miso.launch.grid_interp_per_point", "miso.launch.grid_interp_per_point_grad",
            "miso.launch.mlp_decode", "miso.launch.fused_interp_decode",
            "slam.map", "slam.track"} <= names
    interp, decode = (cells.reader(m).__globals__ for m in ("interp_roofline.map",
                                                            "decode_roofline.map"))
    fragments = (interp["NODE"], decode["NODE"], trace.WINDOW, trace.MARKER,
                 *interp["KERNELS"], *decode["KERNELS"])
    for name in names:
        assert not any(f in name for f in fragments), name
