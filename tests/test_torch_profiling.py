"""The port's spans (``miso_tpu_torch/utils/profiling.py::span``) and the
repaired idle share of ``breakdown``, on the CPU.

* With no profiler recording, ``span`` hands back one shared no-op context
  and never reaches ``record_function``: a whole train step runs with it
  patched to raise.
* Under ``torch.profiler``, the train step's spans land in the Chrome trace
  as ``user_annotation`` events: ``miso.step`` holding, in order,
  ``miso.step.loss``, ``miso.step.grad`` and ``miso.step.update``.
* Each kernel launcher opens its ``miso.launch.*`` span before it checks
  its arguments (CPU tensors are refused inside the span).
* ``busy_us``, the union of intervals that ``breakdown``'s idle share now
  rests on, counts overlapping intervals once.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import mapping_batch, small_cfg, to_torch
from miso_tpu_torch.losses.miso import make_loss, mapping_loss
from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
from miso_tpu_torch.ops import fused_decode, tiled_interp
from miso_tpu_torch.train.optim import masked_adam_init
from miso_tpu_torch.train.trainer import make_train_step
from miso_tpu_torch.utils import profiling

LOSS = dict(loss_type="L2", weight_sdf=1.0, weight_eik=0.0, weight_fs=0.1, trunc_dist=0.15)


def annotations(prof, tmp_path):
    """The trace's ``user_annotation`` events (name, start, end, thread),
    in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda a: a[1])


def small_step(seed=0):
    """A GridNet, its Adam state and mask, one mapping batch and the step."""
    rng = np.random.default_rng(seed)
    cfg = small_cfg(num_poses=3)
    model = create_grid_net(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    batch = to_torch(mapping_batch(rng, 256, 3))
    step = make_train_step(make_loss(mapping_loss, **LOSS), "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    return model, masked_adam_init(model), batch, step, mask


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) opened with no profiler recording")


def test_span_without_a_profiler_opens_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("miso.step"), profiling.span("miso.launch.grid_interp")
    assert first is second is profiling._NO_SPAN
    with first:
        pass
    model, opt, batch, step, mask = small_step()
    before = model.features[1].detach().clone()
    step(model, opt, batch, None, mask, 1e-2)
    assert not torch.equal(model.features[1].detach(), before)


def test_span_under_a_profiler_is_a_record_function(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("miso.test")
        assert s is not profiling._NO_SPAN
        with s:
            torch.ones(4).sum()
    assert [a[0] for a in annotations(prof, tmp_path)] == ["miso.test"]


def test_train_step_spans_nest_in_order(tmp_path):
    """Two steps on one mask, the first and the second alike."""
    model, opt, batch, step, mask = small_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(model, opt, batch, None, mask, 1e-2)
    got = annotations(prof, tmp_path)
    phases = ["miso.step.loss", "miso.step.grad", "miso.step.update"]
    assert [a[0] for a in got] == (["miso.step"] + phases) * 2
    for (_, t0, t1, tid), *inner in (got[:4], got[4:]):
        prev_end = t0
        for name, a, b, thread in inner:
            assert thread == tid, name
            assert prev_end <= a <= b <= t1, name
            prev_end = b


def _launchers():
    """kernel -> (its launcher, a call of it on CPU tensors)."""
    ti, fd = tiled_interp, fused_decode
    grid, x = torch.zeros(4, 4, 4, 2), torch.rand(5, 3)
    bound, g = torch.tensor([[0.0, 1.0]] * 3), torch.zeros(5, 2)
    stacked, ids = torch.zeros(2, 4, 4, 4, 2), torch.zeros(5, dtype=torch.int32)
    bounds, sizes = torch.stack([bound, bound]), torch.full((2, 3), 4, dtype=torch.int32)
    decoder = ((torch.zeros(4, 8), torch.zeros(8)), (torch.zeros(8, 1), torch.zeros(1)))
    per_point = (stacked, ids, x, bounds, sizes)
    return {
        "grid_interp": (ti.grid_interpolate_cuda, (grid, x, bound)),
        "grid_interp_grad": (ti.grid_interpolate_grad_cuda, (grid, x, bound, g)),
        "grid_interp_per_point": (ti.grid_interpolate_per_point_cuda, per_point),
        "grid_interp_per_point_grad": (ti.grid_interpolate_per_point_grad_cuda,
                                       per_point + (g,)),
        "mlp_decode": (fd.mlp_decode_cuda, (decoder, torch.rand(5, 4))),
        "fused_interp_decode": (fd.fused_interp_decode_cuda, ([grid, grid], x, bound, decoder)),
    }


@pytest.mark.parametrize("kernel", sorted(_launchers()))
def test_launcher_opens_its_span(kernel, tmp_path):
    """The span covers the launcher's checks: the refusal of CPU tensors
    happens inside it, and no launch is counted."""
    launcher, args = _launchers()[kernel]
    before = launcher.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="CUDA tensors"):
            launcher(*args)
    assert [a[0] for a in annotations(prof, tmp_path)] == [f"miso.launch.{kernel}"]
    assert launcher.launches == before


def test_busy_counts_overlaps_once():
    assert profiling.busy_us([]) == 0.0
    # [0, 4] and [2, 6] overlap; [5, 7] extends them; [10, 11] stands alone;
    # [10.5, 10.7] lies inside it.
    got = profiling.busy_us([(10.0, 11.0), (0.0, 4.0), (5.0, 7.0), (2.0, 6.0), (10.5, 10.7)])
    assert got == pytest.approx(8.0)
