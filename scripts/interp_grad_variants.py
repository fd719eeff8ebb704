#!/usr/bin/env python3
"""The interp grad kernel against the designs it was measured against, on one
CUDA card.

    python3 scripts/interp_grad_variants.py [--calls N]

Each design computes what ``grid_interpolate_grad_plain`` computes (the
table's gradient and, when asked, the points') and is held to it at 1e-4 of
the largest entry before it is timed.  Designs:

  * ``shipped``: ``grid_interpolate_grad_cuda`` as committed: one thread per
    point, float4 atomics spread over ``interp_grad_copies`` copies of the
    table (timed first and last);
  * ``copies=k``: the committed kernel forced to k copies through its C
    entry; k = 1 scatters into the gradient itself.  The sweep behind
    ``ATOMICS_PER_COPY``, ``MAX_COPIES`` and ``COPY_BUDGET``;
  * ``tiles_T<t>_P<p>``: ``scripts/interp_grad_variants/tiles.cu``, the TPU
    kernel's shape: points binned by t^3-cell tile (counting sort), each tile
    summed in shared memory by blocks of at most p points, one flush per row;
    a table that fits 96 KB of shared memory is one tile and is not sorted;
  * ``cell_sort``: ``scripts/interp_grad_variants/cell_sort.cu``, a counting
    sort by cell and a warp-level reduction of equal cells before the float4
    atomics.

Shapes: ``chip_smoke.INTERP_SHAPES`` (the ScanNet levels at 1e6 points, the
mesh path's at 2^15) and the ScanNet coarse level at 2^15 and 2^16 points
(some 100 and 200 atomics a row, either side of ``ATOMICS_PER_COPY``), table
only (``table``) and with the points' gradient (``points``).  Device time per
call by torch.profiler (``chip_smoke._device_events``), in all and split by
kernel and memset; for ``shipped`` also the wrapper's call time by CUDA
events (``chip_smoke.cuda_ms``), host launch cost included.  Builds the two
variant sources with the port's nvcc flags into
``miso_tpu_torch/_build/variants/interp_grad/``.  Prints the card's name and
power limit, a line per shape and design, then one JSON line.  Imports torch,
chip_smoke and miso_tpu_torch only.
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from miso_tpu_torch.ops import _build  # noqa: E402
from miso_tpu_torch.ops import tiled_interp as ti  # noqa: E402

SOURCES = os.path.join(ROOT, "scripts", "interp_grad_variants")
OUT = _build.BUILD_DIR / "variants" / "interp_grad"
SMEM_BUDGET = 96 << 10       # shared memory a tile may take (dynamic, opted in)
TILE_CONFIGS = [(8, 1024), (8, 4096), (16, 4096)]
COPIES = [1, 2, 4, 8, 16, 32, 64]
COPIES_MAX_BYTES = 64 << 20  # the sweep's largest set of copies


class _TilePlan(ctypes.Structure):
    """``VtPlan`` of tiles.cu."""
    _fields_ = [("tile", ctypes.c_int * 3), ("tiles", ctypes.c_int * 3),
                ("halo", ctypes.c_int * 3), ("single", ctypes.c_int),
                ("per_item", ctypes.c_int), ("n_tiles", ctypes.c_int),
                ("key", ctypes.c_void_p), ("offset", ctypes.c_void_p),
                ("cursor", ctypes.c_void_p), ("item", ctypes.c_void_p),
                ("sorted", ctypes.c_void_p)]


class _CellPlan(ctypes.Structure):
    """``MttGradPlan`` of cell_sort.cu."""
    _fields_ = [("cells", ctypes.c_int * 3), ("segments", ctypes.c_int),
                ("key", ctypes.c_void_p), ("sorted", ctypes.c_void_p),
                ("count", ctypes.c_void_p), ("seg_start", ctypes.c_void_p)]


def build():
    """Both variant libraries, one nvcc each, at once; prints ptxas's
    registers and spills of each kernel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("tiles", "cell_sort"):
        lib = OUT / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               os.path.join(SOURCES, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    libs["tiles"].vt_grid_interp_backward.argtypes = [
        ctypes.POINTER(ti._InterpArgs), ctypes.POINTER(_TilePlan), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    libs["cell_sort"].vc_grid_interp_backward.argtypes = [
        ctypes.POINTER(ti._InterpArgs), ctypes.POINTER(_CellPlan), ctypes.c_int, ctypes.c_void_p]
    return libs


def _int32(n, dev):
    return torch.empty(max(n, 1), dtype=torch.int32, device=dev)


def _outputs(grid, x, need_x):
    d_grid = torch.empty_like(grid)
    d_x = torch.empty((x.shape[0], 3), device=x.device) if need_x else None
    return d_grid, d_x


def _caller(fn, keep, *structs):
    """A function that launches ``fn`` on the structs on the current stream
    and raises on its error code; ``keep`` holds the scratch alive."""
    dev = torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        code = fn(*(ctypes.byref(s) if isinstance(s, ctypes.Structure) else s
                    for s in structs), dev, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: {ti._library().mtt_error_string(code)}")
    run.keep = keep
    return run


def copies_runner(grid, x, bound, g, need_x, copies):
    d_grid, d_x = _outputs(grid, x, need_x)
    plan = ti._GradPlanArgs(copies, None)
    partial = None
    if copies > 1:
        partial = torch.empty(copies * grid.numel(), device=x.device)
        plan.partial = partial.data_ptr()
    a = ti._pack(grid, x, bound, None, d_grid, g, d_x)
    return _caller(ti._library().mtt_grid_interp_backward, partial, a, plan), (d_grid, d_x)


def tiles_runner(lib, grid, x, bound, g, need_x, tile, per_item):
    dims, fdim, n = tuple(grid.shape[:3]), grid.shape[-1], x.shape[0]
    row_bytes = 4 * fdim * (2 if need_x else 1)
    plan = _TilePlan()
    plan.single = int(math.prod(dims) * row_bytes <= SMEM_BUDGET)
    if plan.single:
        plan.tile[:], plan.tiles[:], plan.halo[:] = dims, (1, 1, 1), dims
    else:
        t = [min(tile, d + 1) for d in dims]
        plan.tile[:] = t
        plan.tiles[:] = [-(-(d + 1) // tk) for d, tk in zip(dims, t)]
        plan.halo[:] = [tk + 1 for tk in t]
    plan.per_item = per_item
    plan.n_tiles = math.prod(plan.tiles)
    smem = math.prod(plan.halo) * row_bytes
    if smem > 227 << 10:
        raise SystemExit(f"tile of {smem} B of shared memory")
    scratch = [_int32(n, x.device), _int32(plan.n_tiles + 1, x.device),
               _int32(plan.n_tiles, x.device), _int32(plan.n_tiles + 1, x.device),
               _int32(n, x.device)]
    plan.key, plan.offset, plan.cursor, plan.item, plan.sorted = (
        t.data_ptr() for t in scratch)
    items = -(-n // per_item) + (0 if plan.single else plan.n_tiles)
    d_grid, d_x = _outputs(grid, x, need_x)
    a = ti._pack(grid, x, bound, None, d_grid, g, d_x)
    run = _caller(lib.vt_grid_interp_backward, scratch, a, plan, ctypes.c_int(items),
                  ctypes.c_int(smem))
    return run, (d_grid, d_x)


def cell_runner(lib, grid, x, bound, g, need_x):
    dims, n = tuple(grid.shape[:3]), x.shape[0]
    plan = _CellPlan()
    plan.cells[:] = [d + 1 for d in dims]
    plan.segments = -(-math.prod(plan.cells) // 1024)
    scratch = [_int32(n, x.device), _int32(n, x.device),
               _int32(plan.segments * 1024, x.device), _int32(plan.segments + 1, x.device)]
    plan.key, plan.sorted, plan.count, plan.seg_start = (t.data_ptr() for t in scratch)
    d_grid, d_x = _outputs(grid, x, need_x)
    a = ti._pack(grid, x, bound, None, d_grid, g, d_x)
    return _caller(lib.vc_grid_interp_backward, scratch, a, plan), (d_grid, d_x)


def _short(name):
    """A kernel's name without its template and arguments."""
    name = name.split("(")[0].split("<")[0]
    return name[5:] if name.startswith("void ") else name


def measure(run, got, ref, need_x, calls):
    """Errors against the plain version (relative to its largest entry), then
    the device time per call, in all and by kernel."""
    run()
    torch.cuda.synchronize()
    errs = {}
    for key, a, b in (("table", got[0], ref[0]), ("points", got[1], ref[1])):
        if key == "points" and not need_x:
            continue
        err = float((a - b).abs().max())
        errs[key] = err / max(float(b.abs().max()), 1e-6)
    ok = all(e <= chip_smoke.GRAD_RTOL_OF_MAX for e in errs.values())
    for _ in range(2):  # the profiler now and then returns a window short of events
        events = chip_smoke._device_events(run, calls)
        if events and len(events) % calls == 0:
            break
    else:
        return {"ms": None, "split": {}, "rel_err": errs, "ok": ok}
    split = defaultdict(float)
    for name, us in events:
        split[_short(name)] += us / calls / 1e3
    return {"ms": sum(split.values()), "split": dict(split), "rel_err": errs, "ok": ok}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=chip_smoke.TIMED_CALLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interp_grad_variants: needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build()
    g = chip_smoke.SCANNET_MODEL["grid"]["bound"]
    shapes = chip_smoke.INTERP_SHAPES + [("scannet_coarse_2^15", g, 0.5, 2 ** 15),
                                         ("scannet_coarse_2^16", g, 0.5, 2 ** 16)]
    report, ok = {}, True
    for seed, (name, bound_list, cell, n) in enumerate(shapes, start=200):
        grid, x, bound = chip_smoke._grid_case(bound_list, cell, 4, n, seed)
        cot = torch.randn((n, 4), generator=torch.Generator(device=x.device).manual_seed(seed),
                          device=x.device)
        rows = math.prod(grid.shape[:3])
        shipped = ti.interp_grad_copies(grid.shape[:3], 4, n)
        rec = {"grid": list(grid.shape), "points": n, "atomics_per_row": 8 * n / rows,
               "shipped_copies": shipped, "designs": defaultdict(dict)}
        for key, need_x in (("table", False), ("points", True)):
            ref = ti.grid_interpolate_grad_plain(grid, x, bound, cot, need_x=need_x)
            designs = {"shipped": None}
            designs.update({f"copies={k}": (copies_runner, k) for k in COPIES
                            if k * grid.numel() * 4 <= COPIES_MAX_BYTES})
            designs.update({f"tiles_T{t}_P{p}": (tiles_runner, libs["tiles"], t, p)
                            for t, p in TILE_CONFIGS})
            designs["cell_sort"] = (cell_runner, libs["cell_sort"])
            designs["shipped_again"] = None
            for design, spec in designs.items():
                if spec is None:
                    call = lambda: ti.grid_interpolate_grad_cuda(grid, x, bound, cot,
                                                                 need_x=need_x)
                    got = call()
                    res = measure(call, got, ref, need_x, args.calls)
                    res["call_ms"] = chip_smoke.cuda_ms(call, calls=args.calls)
                else:
                    fn, *extra = spec
                    if fn is copies_runner:
                        run, got = fn(grid, x, bound, cot, need_x, *extra)
                    else:
                        run, got = fn(extra[0], grid, x, bound, cot, need_x, *extra[1:])
                    res = measure(run, got, ref, need_x, args.calls)
                ok &= res["ok"]
                rec["designs"][design][key] = res
                ms = "not read" if res["ms"] is None else f"{res['ms']:.4f} ms"
                print(f"  {name} {tuple(grid.shape)} x {n} {key} {design}: {ms}" +
                      (f" (call {res['call_ms']:.4f} ms)" if "call_ms" in res else "") +
                      f", rel err {max(res['rel_err'].values(), default=0):.1e}"
                      f"{'' if res['ok'] else ' FAILED'}; " +
                      ", ".join(f"{k} {v:.4f}" for k, v in res["split"].items()), flush=True)
            del ref
        report[name] = rec
        del grid, x, cot
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "shapes": report}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
