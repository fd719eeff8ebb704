#!/usr/bin/env python3
"""The decode kernel against variants of its design, on one CUDA card.

    python3 scripts/decode_variants.py

Each variant is the kernel's sources (miso_tpu_torch/csrc) with a few text
edits, built by nvcc with the port's flags into miso_tpu_torch/_build/
variants/<name>/.  An edit that no longer matches the sources stops the
script, so every variant differs from the committed kernel by exactly what
its name says.  For the kernel as committed and each variant it prints the
registers and spills of the 8->64->64->1 instantiation, the largest error
against the plain version at two shapes (8->64->64->1 and 12->128->128->17,
1e5 + 3 points; atol/rtol 1e-4), and the device time per launch at 2^18 and
1e6 points of the ScanNet decoder (CUDA events around 20 launches with packed
arguments, so without the wrapper's host time), the committed kernel timed
first and last.  Imports torch and miso_tpu_torch only.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from miso_tpu_torch.ops import _build  # noqa: E402
from miso_tpu_torch.ops import fused_decode as fd  # noqa: E402
from miso_tpu_torch.ops.mlp import mlp_init  # noqa: E402

HDR, SRC = "mtt_mma.cuh", "mlp_decode.cu"

# name: (what it tests, [(file, text in the committed source, replacement)]).
VARIANTS = {
    "cvt_split": ("hi and lo by cvt.rna.tf32.f32 instead of integer rounding", [
        (HDR, """  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;""",
         """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));""")]),
    "presplit": ("weights split into hi and lo once, at staging (twice the shared memory)", [
        (HDR, "      ws[i] = (k < in && n < out) ? W[k * out + n] : 0.f;",
         """      uint32_t hi, lo;
      mtt_split((k < in && n < out) ? W[k * out + n] : 0.f, hi, lo);
      ws[2 * (i & ~1) + (i & 1)] = __uint_as_float(hi);
      ws[2 * (i & ~1) + 2 + (i & 1)] = __uint_as_float(lo);"""),
        (HDR, "    float* ws = smem + m.woff[l];", "    float* ws = smem + 2 * m.woff[l];"),
        (HDR, "    float* bs = smem + m.boff[l];", "    float* bs = smem + 2 * m.boff[l];"),
        (HDR, "    const float* bs = smem + m.boff[l];", "    const float* bs = smem + 2 * m.boff[l];"),
        (HDR, "const float2* ws = reinterpret_cast<const float2*>(smem + m.woff[l]) + lane;",
         "const float4* ws = reinterpret_cast<const float4*>(smem + 2 * m.woff[l]) + lane;"),
        (HDR, "mtt_mma_layer(const float2* __restrict__ ws", "mtt_mma_layer(const float4* __restrict__ ws"),
        (HDR, """          const float2 w = ws[(kt * stride + nt) * 32];
          uint32_t bhi0, blo0, bhi1, blo1;
          mtt_split(w.x, bhi0, blo0);
          mtt_split(w.y, bhi1, blo1);""",
         """          const float4 w = ws[(kt * stride + nt) * 32];
          const uint32_t bhi0 = __float_as_uint(w.x), bhi1 = __float_as_uint(w.y);
          const uint32_t blo0 = __float_as_uint(w.z), blo1 = __float_as_uint(w.w);"""),
        (HDR, "reinterpret_cast<const float2*>(smem + m.woff[l]), k_tiles,",
         "reinterpret_cast<const float2*>(smem + 2 * m.woff[l]), k_tiles,"),
        (HDR, "          const float2 w = ws[kt * 32 + 4 * j + q];",
         "          const float4 w4 = reinterpret_cast<const float4*>(ws)[kt * 32 + 4 * j + q];\n"
         "          const float2 w = make_float2(w4.x + w4.z, w4.y + w4.w);"),
        (SRC, "mtt_mma_launch(kernel, a, a.n, rows, a.mlp.smem_bytes, device, stream)",
         "mtt_mma_launch(kernel, a, a.n, rows, 2 * a.mlp.smem_bytes, device, stream)")]),
    "mma_output_layer": ("the output layer on the tensor cores too, no FP32 dot layer", [
        (HDR, "if (l + 1 == m.n_layers && m.dims[l + 1] <= 4) {", "if (false) {")]),
    "guarded": ("every n tile guarded, no unguarded path for full-width layers", [
        (HDR, "} else if (n_tiles == NT) {", "} else if (false) {")]),
    "min_blocks_2": ("registers cut for 2 blocks (8 warps) per SM instead of 3", [
        (HDR, "#define MTT_MMA_MIN_BLOCKS 3", "#define MTT_MMA_MIN_BLOCKS 2")]),
    "mt1": ("16-point warp tiles at NT = 8 (one B read feeds 3 mma), 4 blocks per SM", [
        (SRC, "*rows_per_warp = t <= 8 ? 32 : 16;", "*rows_per_warp = t <= 4 ? 32 : 16;"),
        (SRC, "return mlp_decode_kernel<8, 2>;", "return mlp_decode_kernel<8, 1>;"),
        (HDR, "#define MTT_MMA_MIN_BLOCKS 3", "#define MTT_MMA_MIN_BLOCKS 4")]),
    "relu_select": ("ReLU as a compare and select instead of an integer max", [
        (HDR, "  return __int_as_float(max(__float_as_int(v), 0));",
         "  return v < 0.f ? 0.f : v;")]),
}


def build(name, edits):
    """Copy csrc, apply the edits, start nvcc; returns (process, library path)."""
    d = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in edits:
        p = d / fname
        text = p.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: edit of {fname} does not match:\n{old}")
        p.write_text(text.replace(old, new))
    lib = d / "lib.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def registers(log):
    """Registers and spills of the NT = 8 instantiation, from ptxas -v."""
    m = re.search(r"mlp_decode_kernelILi8ELi\dE.*?\n(.*?spill loads).*?\n.*?Used (\d+) "
                  r"registers", log, re.S)
    if not m:
        return "?"
    spill = re.search(r"(\d+) bytes spill stores", m.group(1)).group(1)
    return f"{m.group(2)} registers, {spill} B spilled"


def launcher(lib, params, x):
    """A function launching lib's kernel on packed arguments; and its output."""
    fn = ctypes.CDLL(str(lib)).mtt_mlp_decode
    fn.argtypes = [ctypes.POINTER(fd._DecodeArgs), ctypes.c_int, ctypes.c_void_p]
    a, dims = fd._decode_args(params, x)
    out = torch.empty((x.shape[0], dims[-1]), device=x.device)
    a.out = out.data_ptr()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        code = fn(ctypes.byref(a), x.device.index, stream)
        if code != 0:
            raise RuntimeError(f"launch failed: {code}")
    return run, out


def device_ms(run, calls=20):
    for _ in range(3):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    builds = {"committed": build("committed", [])}
    builds.update({name: build(name, edits) for name, (_, edits) in VARIANTS.items()})
    libs = {}
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}")
            return 1
        libs[name] = (lib, registers(log))
    checks = [mlp_init(8, 1, 64, 1, generator=torch.Generator().manual_seed(1), device=dev),
              mlp_init(12, 17, 128, 1, generator=torch.Generator().manual_seed(2), device=dev)]
    scannet = checks[0]
    ok = True
    order = ["committed", *VARIANTS, "committed"]
    times = {}
    for n in (2 ** 18, 1_000_000):
        x = torch.randn((n, 8), generator=torch.Generator(device=dev).manual_seed(n),
                        device=dev)
        for name in order:
            run, _ = launcher(libs[name][0], scannet, x)
            times.setdefault(name, {}).setdefault(n, []).append(device_ms(run))
    for name in ["committed", *VARIANTS]:
        errs = []
        for params in checks:
            x = torch.randn((100_003, params[0][0].shape[0]), device=dev)
            run, out = launcher(libs[name][0], params, x)
            run()
            ref = fd.mlp_decode_plain(params, x)
            torch.cuda.synchronize()
            errs.append(float((out - ref).abs().max()))
            ok &= bool(torch.allclose(out, ref, atol=1e-4, rtol=1e-4))
        what = VARIANTS[name][0] if name in VARIANTS else "the kernel as committed"
        t = times[name]
        print(f"{name}: {what}; {libs[name][1]}; max err {max(errs):.2e}; "
              f"2^18 points {' / '.join(f'{v:.4f}' for v in t[2 ** 18])} ms, "
              f"1e6 points {' / '.join(f'{v:.4f}' for v in t[1_000_000])} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
