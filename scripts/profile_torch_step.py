#!/usr/bin/env python3
"""Where the port's mapping train step spends its device time, on one CUDA card.

    python3 scripts/profile_torch_step.py

Builds chip_smoke.py's main path (ScanNet widths, decoder.impl "pallas",
1e6-point batches, masked Adam), runs 3 warm-up steps, 5 steps unprofiled,
then 5 steps under torch.profiler (CPU and CUDA activity).  Prints the card,
both windows' wall time per step (host clock, synchronised), the device time
per step summed over kernels and copies, the idle share (device time against
the unprofiled window), and the kernels by device time with
their share of the step, then the aten operators by the device time of the
kernels they launched.  Imports torch, numpy, chip_smoke and miso_tpu_torch.
"""
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = 5
TOP = 25


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from miso_tpu_torch.losses.miso import make_loss, mapping_loss
    from miso_tpu_torch.models.grid_net import create_grid_net, grid_net_mask
    from miso_tpu_torch.train.optim import masked_adam_init
    from miso_tpu_torch.train.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    model = create_grid_net(chip_smoke.SCANNET_MODEL,
                            generator=torch.Generator().manual_seed(0), device=dev)
    batches = chip_smoke.mapping_batches(chip_smoke.N_POINTS, 4, dev)
    step = make_train_step(make_loss(mapping_loss, **chip_smoke.MAPPING_HYPER), "adam")
    mask = grid_net_mask(model, level=model.num_levels, pose=False)
    opt = masked_adam_init(model)
    for i in range(3):
        model, opt, tl, _ = step(model, opt, batches[i % 4], None, mask, 1e-3)
    torch.cuda.synchronize()

    # The same window without the profiler, whose host cost inflates the
    # profiled wall time: the idle share is read against this one.
    t0 = time.perf_counter()
    for i in range(STEPS):
        model, opt, tl, _ = step(model, opt, batches[i % 4], None, mask, 1e-3)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            model, opt, tl, _ = step(model, opt, batches[i % 4], None, mask, 1e-3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = per_name[e.name]
            rec[0] += e.time_range.elapsed_us() / 1e3 / STEPS
            rec[1] += 1
    device_ms = sum(v[0] for v in per_name.values())
    print(f"window: {STEPS} steps; wall {plain_wall_ms:.3f} ms/step unprofiled, "
          f"{wall_ms:.3f} profiled (host clock); device {device_ms:.3f} ms/step "
          f"summed over kernels; idle share "
          f"{max(0.0, 1.0 - device_ms / plain_wall_ms):.3f} of the unprofiled window")
    print(f"{'ms/step':>9} {'share':>6} {'calls/step':>10}  kernel")
    for name, (ms, calls) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{ms:9.4f} {ms / device_ms:6.3f} {calls / STEPS:10.1f}  {name[:110]}")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    print(f"{'ms/step':>9} {'calls/step':>10}  operator (self device time)")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"{e.self_device_time_total / 1e3 / STEPS:9.4f} {e.count / STEPS:10.1f}  {e.key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
