#!/usr/bin/env python3
"""The interp forward and the fused interp+decode kernel against the designs
they were measured against, and the card's L2 gather rate, on one CUDA card.

    python3 scripts/interp_fwd_variants.py [--calls N]

Every design is held to its plain version (``grid_interpolate_plain``,
``fused_interp_decode_plain``) at atol/rtol 1e-4 before it is timed.  Device
time per call by torch.profiler (``chip_smoke._device_events``), in all and
split by kernel; for the shipped wrappers also the call by CUDA events
(``chip_smoke.cuda_ms``), host launch cost included.

  * ``probe``: ``scripts/interp_fwd_variants/forward.cu::vf_probe``, 1e6
    threads each summing random float4 of a table of the fine ScanNet level's
    size (4.6 MB) and of the mesh path's fine level (1.1 MB): 8 random float4
    a thread (8 sectors), 4 (4 sectors), 4 random 32-byte-aligned pairs (8
    requests, 4 sectors) and 4 pairs at any float4 (as a point's corner pairs
    lie: 8 requests, 6 sectors on average).  The L2 gather ceiling the interp
    forward's design is held to.
  * the interp forward at ``chip_smoke.INTERP_SHAPES`` (the ScanNet levels at
    1e6 points, the mesh path's at 2^15), the mesh levels at one 2^18-point
    lattice chunk (F = 4), and the ScanNet coarse level at F = 8 and 12
    (tables of 85 KB and 127 KB) with 1e6 points: ``shipped`` (the wrapper,
    on the path ``interp_forward_path`` picks; timed first and last), ``l2``,
    ``pairs`` and ``staged`` (the shipped C entry forced to each path, the
    staged one where the table fits a block; ``pairs`` at F = 8 and 12 from
    ``forward.cu::vf_pairs``, the same design for wider rows),
    and from ``forward.cu``: ``l2_generic`` (the L2 kernel with F a run-time
    value),
    and at F = 4 ``staged256`` (the staged kernel in 256-thread blocks, as
    many as fit) and ``ilp<k>`` (k points a thread, all 8k loads issued
    first);
  * the fused kernel at the ScanNet widths with 1e6 points: ``shipped``,
    ``all_l2`` (no table staged), ``fma_u`` (``csrc`` with u contracted into
    an FMA in ``mtt_grid.cuh``, as the first fused kernel rounded it), ``old``
    (``scripts/interp_fwd_variants/fused_old.cu``: the first design, one
    thread a point, FP32 MLP from shared memory) and ``parts`` (the interp
    forward at both levels then the decode kernel, as GridNet's default
    decode runs them).

Builds the variant sources with the port's nvcc flags into
``miso_tpu_torch/_build/variants/interp_fwd/``.  Prints the card's name and
power limit, a line per design, then one JSON line.  Imports torch, numpy,
chip_smoke and miso_tpu_torch only.
"""
import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from miso_tpu_torch.ops import _build  # noqa: E402
from miso_tpu_torch.ops import fused_decode as fd  # noqa: E402
from miso_tpu_torch.ops import tiled_interp as ti  # noqa: E402

SOURCES = os.path.join(ROOT, "scripts", "interp_fwd_variants")
OUT = _build.BUILD_DIR / "variants" / "interp_fwd"
# The first fused kernel's u: the multiply and subtract contracted.
U_OP_BY_OP = ("__fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(xp[k], lo[k]), ext[k]), "
              "(float)nk), 0.5f);")
U_FMA = "(xp[k] - lo[k]) / ext[k] * (float)nk - 0.5f;"
PROBES = [("float4x8", 8, 0), ("float4x4", 4, 0), ("pairs_aligned", 8, 1),
          ("pairs_any", 8, 2)]
ILP = [1, 2, 4]


def build():
    """forward.cu, fused_old.cu and csrc's fused kernel with an FMA u, one
    nvcc each, at once; prints ptxas's registers and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    fma = OUT / "fma_u"
    shutil.rmtree(fma, ignore_errors=True)
    shutil.copytree(_build.CSRC, fma)
    hdr = fma / "mtt_grid.cuh"
    text = hdr.read_text()
    if U_OP_BY_OP not in text:
        raise SystemExit("mtt_grid.cuh no longer rounds u as this script edits it")
    hdr.write_text(text.replace(U_OP_BY_OP, U_FMA))
    jobs = {"forward": (os.path.join(SOURCES, "forward.cu"), _build.CSRC),
            "fused_old": (os.path.join(SOURCES, "fused_old.cu"), _build.CSRC),
            "fma_u": (str(fma / "fused_interp_decode.cu"), fma)}
    procs = {}
    for name, (src, inc) in jobs.items():
        lib = OUT / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(lib), src]
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
    f = libs["forward"]
    f.vf_probe.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    f.vf_ilp.argtypes = [ctypes.POINTER(ti._InterpArgs), ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
    f.vf_staged256.argtypes = [ctypes.POINTER(ti._InterpArgs), ctypes.c_int, ctypes.c_void_p]
    f.vf_l2_generic.argtypes = [ctypes.POINTER(ti._InterpArgs), ctypes.c_int, ctypes.c_void_p]
    f.vf_pairs.argtypes = [ctypes.POINTER(ti._InterpArgs), ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
    f.mtt_grid_interp_forward.argtypes = [ctypes.POINTER(ti._InterpArgs), ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    libs["fused_old"].vf_old_fused_interp_decode.argtypes = [
        ctypes.POINTER(_OldFusedArgs), ctypes.c_int, ctypes.c_void_p]
    libs["fma_u"].mtt_fused_interp_decode.argtypes = [
        ctypes.POINTER(fd._FusedArgs), ctypes.c_int, ctypes.c_void_p]
    return libs


def _caller(fn, keep, *args):
    """Launch ``fn`` on args (structs by reference) on the current stream;
    raise on its error code.  ``keep`` holds scratch alive."""
    dev = torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    refs = [ctypes.byref(a) if isinstance(a, ctypes.Structure) else a for a in args]

    def run():
        code = fn(*refs, dev, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: {ti._library().mtt_error_string(code)}")
    run.keep = (keep, args)
    return run


def _short(name):
    name = name.split("(")[0].split("<")[0]
    return name[5:] if name.startswith("void ") else name


def measure(run, got, ref, calls):
    """The largest error against the plain version and whether it is within
    atol/rtol 1e-4, then the device time per call, in all and by kernel."""
    run()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if ref is not None else 0.0
    ok = ref is None or bool(torch.allclose(got, ref, atol=chip_smoke.VALUE_ATOL,
                                            rtol=chip_smoke.VALUE_RTOL))
    for _ in range(2):  # the profiler now and then returns a window short of events
        events = chip_smoke._device_events(run, calls)
        if events and len(events) % calls == 0:
            break
    else:
        return {"ms": None, "split": {}, "max_abs_err": err, "ok": ok}
    split = defaultdict(float)
    for name, us in events:
        split[_short(name)] += us / calls / 1e3
    return {"ms": sum(split.values()), "split": dict(split), "max_abs_err": err, "ok": ok}


def _line(label, res):
    ms = "not read" if res["ms"] is None else f"{res['ms']:.4f} ms"
    extra = f" (call {res['call_ms']:.4f} ms)" if "call_ms" in res else ""
    print(f"  {label}: {ms}{extra}, max err {res['max_abs_err']:.1e}"
          f"{'' if res['ok'] else ' FAILED'}; " +
          ", ".join(f"{k} {v:.4f}" for k, v in res["split"].items()), flush=True)


def probes(lib, calls):
    """The random-gather probe at the fine ScanNet and mesh table sizes."""
    out, dev = {}, torch.device("cuda")
    res_out = torch.empty((10 ** 6, 4), device=dev)
    for name, shape in (("scannet_fine", (105, 88, 31)), ("mesh_fine", (50, 50, 27))):
        rows = math.prod(shape)
        table = torch.randn((rows, 4), device=dev)
        for probe, loads, mode in PROBES:
            run = _caller(lib.vf_probe, table, ctypes.c_void_p(table.data_ptr()),
                          ctypes.c_uint(rows), ctypes.c_longlong(10 ** 6), loads, mode,
                          ctypes.c_void_p(res_out.data_ptr()))
            res = measure(run, res_out, None, calls)
            res["table_bytes"] = rows * 16
            out[f"{name}_{probe}"] = res
            _line(f"probe {name} ({rows * 16} B) {probe}, 1e6 threads", res)
    return out


def forward_designs(libs, calls):
    """The interp forward's designs at the paths' shapes."""
    from miso_tpu_torch.utils.sdf import lattice_chunk_points
    lib = libs["forward"]
    mesh_bound = chip_smoke.MESH_BOUND
    shapes = [(name, bl, cell, n, 4, None) for name, bl, cell, n in chip_smoke.INTERP_SHAPES]
    shapes += [(f"lattice_{lvl}", mesh_bound, cell, chip_smoke.MESH_CHUNK, 4, "lattice")
               for lvl, cell in (("fine", 0.1), ("coarse", 0.5))]
    scannet = chip_smoke.SCANNET_MODEL["grid"]["bound"]
    shapes += [(f"scannet_coarse_F{f}", scannet, 0.5, chip_smoke.N_POINTS, f, None)
               for f in (8, 12)]
    report = {}
    for seed, (name, bl, cell, n, fdim, where) in enumerate(shapes, start=300):
        grid, x, bound = chip_smoke._grid_case(bl, cell, fdim, n, seed)
        if where == "lattice":
            res = chip_smoke.MESH_RESOLUTION
            x = lattice_chunk_points(bound, res, res ** 3 // 2 - n // 2, n).contiguous()
        ref = ti.grid_interpolate_plain(grid, x, bound)
        fits = ti.staged_tables([ti.table_bytes(grid)], 0, 1)[0]  # at one block an SM
        rec = {"grid": list(grid.shape), "points": n, "table_bytes": ti.table_bytes(grid),
               "shipped_path": ti.interp_forward_path(grid, n, True), "designs": {}}
        designs = ["shipped", "l2", "l2_generic", "pairs"]
        designs += ["staged"] if fits else []
        if fdim == 4:
            designs += ["staged256"] if fits else []
            designs += [f"ilp{k}" for k in ILP]
        designs += ["shipped_again"]
        for design in designs:
            out = torch.empty_like(ref)
            a = ti._pack(grid, x, bound, None, out)
            if design.startswith("shipped"):
                run = lambda: ti.grid_interpolate_cuda(grid, x, bound)  # noqa: E731
                out = run()
            elif design == "l2":
                run = _caller(lib.mtt_grid_interp_forward, out, a, 0, None)
            elif design == "l2_generic":
                run = _caller(lib.vf_l2_generic, out, a)
            elif design == "pairs":
                pairs = torch.empty(2 * grid.numel(), device=x.device)
                run = (_caller(lib.mtt_grid_interp_forward, (out, pairs), a, 2,
                               ctypes.c_void_p(pairs.data_ptr())) if fdim == 4 else
                       _caller(lib.vf_pairs, (out, pairs), a, ctypes.c_void_p(pairs.data_ptr())))
            elif design == "staged":
                run = _caller(lib.mtt_grid_interp_forward, out, a, 1, None)
            elif design == "staged256":
                run = _caller(lib.vf_staged256, out, a)
            else:
                run = _caller(lib.vf_ilp, out, a, int(design[3:]))
            r = measure(run, out, ref, calls)
            if design.startswith("shipped"):
                r["call_ms"] = chip_smoke.cuda_ms(run, calls=calls)
            rec["designs"][design] = r
            _line(f"interp {name} {tuple(grid.shape)} x {n} {design}", r)
        report[name] = rec
    return report


class _OldMlp(ctypes.Structure):
    """``MttMlp`` of fused_old.cu."""
    _fields_ = [("n_layers", ctypes.c_int), ("max_width", ctypes.c_int),
                ("w_floats", ctypes.c_int), ("smem_bytes", ctypes.c_int),
                ("W", ctypes.c_void_p * fd.MAX_LAYERS),
                ("b", ctypes.c_void_p * fd.MAX_LAYERS),
                ("dims", ctypes.c_int * (fd.MAX_LAYERS + 1)),
                ("outp", ctypes.c_int * fd.MAX_LAYERS),
                ("woff", ctypes.c_int * fd.MAX_LAYERS),
                ("boff", ctypes.c_int * fd.MAX_LAYERS)]


class _OldLevel(ctypes.Structure):
    _fields_ = [("grid", ctypes.c_void_p), ("size", ctypes.c_void_p),
                ("dims", ctypes.c_int * 3)]


class _OldFusedArgs(ctypes.Structure):
    """``MttFusedArgs`` of fused_old.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("bound", ctypes.c_void_p),
                ("ignore", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("n_levels", ctypes.c_int),
                ("fdim", ctypes.c_int), ("levels", _OldLevel * fd.MAX_LEVELS),
                ("mlp", _OldMlp)]


OLD_THREADS = 64


def old_fused_args(grids, x, bound, decoder, out):
    """fused_old.cu's arguments: each layer's output width padded to a
    multiple of 16 (of 4 below 16), W[l] then b[l] back to back, then two
    activation buffers of max(dims) floats a thread."""
    dims = [len(grids) * grids[0].shape[-1]] + [W.shape[1] for W, _ in decoder]
    a = _OldFusedArgs()
    a.x, a.bound, a.out, a.ignore = x.data_ptr(), bound.data_ptr(), out.data_ptr(), None
    a.n, a.n_levels, a.fdim = x.shape[0], len(grids), grids[0].shape[-1]
    for l, g in enumerate(grids):
        a.levels[l].grid, a.levels[l].size = g.data_ptr(), None
        a.levels[l].dims[:] = list(g.shape[:3])
    m, off = a.mlp, 0
    for i, (W, b) in enumerate(decoder):
        o = dims[i + 1]
        m.outp[i] = -(-o // 16) * 16 if o >= 16 else -(-o // 4) * 4
        m.W[i], m.b[i] = W.data_ptr(), b.data_ptr()
        m.woff[i] = off
        off += dims[i] * m.outp[i]
        m.boff[i] = off
        off += m.outp[i]
    m.n_layers, m.max_width, m.w_floats = len(decoder), max(dims), off
    m.smem_bytes = (off + 2 * max(dims) * OLD_THREADS) * 4
    m.dims[:len(dims)] = dims
    return a


def fused_designs(libs, calls):
    """The fused kernel's designs at the ScanNet widths with 1e6 points."""
    from miso_tpu_torch.ops.fused_decode import (fused_interp_decode_cuda,
                                                 fused_interp_decode_plain, mlp_decode_cuda)
    from miso_tpu_torch.ops.tiled_interp import grid_interpolate_cuda
    g = chip_smoke.SCANNET_MODEL["grid"]
    cells = [g["base_cell_size"] / g["per_level_scale"] ** l for l in range(g["n_levels"])]
    grids, x, bound, decoder = chip_smoke._setup(g["bound"], cells, 4, 64, 1, 1,
                                                 chip_smoke.N_POINTS, seed=1)
    with torch.no_grad():
        ref = fused_interp_decode_plain(grids, x, bound, decoder)
    dims = [8, 64, 64, 1]
    report = {}
    for design in ("shipped", "all_l2", "fma_u", "old", "parts", "shipped_again"):
        out = torch.empty_like(ref)
        if design.startswith("shipped"):
            run = lambda: fused_interp_decode_cuda(grids, x, bound, decoder)  # noqa: E731
            out = run()
        elif design == "parts":
            def run():
                feats = torch.cat([grid_interpolate_cuda(t, x, bound) for t in grids], dim=-1)
                return mlp_decode_cuda(decoder, feats)
            out = run()
        elif design == "old":
            a = old_fused_args(grids, x, bound, decoder, out)
            run = _caller(libs["fused_old"].vf_old_fused_interp_decode, out, a)
        else:
            a = fd.pack_args(grids, x, bound, decoder, None, None, out, dims)
            lib = fd._library()
            if design == "all_l2":
                lay = fd.fused_layout(dims, [fd.SMEM_LIMIT + 1] * len(grids))
                a.smem_bytes = lay["smem_bytes"]
                for lvl in range(len(grids)):
                    a.levels[lvl].staged, a.levels[lvl].soff = 0, 0
            else:
                lib = libs["fma_u"]
            run = _caller(lib.mtt_fused_interp_decode, out, a)
        with torch.no_grad():
            r = measure(run, out, ref, calls)
            if design.startswith("shipped") or design == "parts":
                r["call_ms"] = chip_smoke.cuda_ms(run, calls=calls)
        report[design] = r
        _line(f"fused scannet x {chip_smoke.N_POINTS} {design}", r)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=chip_smoke.TIMED_CALLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interp_fwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build()
    report = {"card": card, "probe": probes(libs["forward"], args.calls),
              "forward": forward_designs(libs, args.calls),
              "fused": fused_designs(libs, args.calls)}
    print(json.dumps(report), flush=True)
    ok = all(r["ok"] for shape in report["forward"].values()
             for r in shape["designs"].values())
    ok &= all(r["ok"] for r in report["fused"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
