// Trilinear corner indices and weights of one point on one grid level, and the
// per-level gather built on them, shared by the kernels that read or write
// feature grids (fused_interp_decode.cu, grid_interp.cu).
//
// Exactly ops/interp.py::corner_indices_and_weights: continuous index
// u = (x - lo) / (hi - lo) * n - 0.5 per axis (align_corners=False), corners
// floor(u) and floor(u) + 1, zeros padding (a corner outside [0, n) has weight
// 0), an optional run-time logical size n below the static storage shape (it
// sets validity and clipping; the storage shape sets the strides), corners in
// itertools.product order (axis 0 varies slowest).
//
// The gather (mtt_lerp) reads a level's corner rows either from a copy of the
// table staged in the block's shared memory (mtt_stage_table) or from global
// memory through the read-only cache, where an L2-resident table is served.
// A table's elements are float or __nv_bfloat16 (bf16 feature storage,
// grid.feature_dtype: bfloat16).  A bf16 row is read as it is stored (at F = 4
// one 8-byte load), widened to float32, which is exact, and lerped in float32,
// as the JAX package gathers bf16 and promotes it against float32 weights; a
// bf16 table is staged as bf16, in half the shared memory.
// Which levels are staged is decided on the host
// (ops/tiled_interp.py::staged_tables).  A staged copy covers the whole
// storage, padded rows included: corners clip to min(n, storage) - 1, so every
// row a corner indexes lies in it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mtt_common.cuh"

// Per-axis terms of one point.
struct MttAxes {
  int i0[3];     // floor(u)
  float fr[3];   // u - floor(u)
  int n[3];      // logical size (sets validity)
  int hi[3];     // largest index a corner clips to: min(n, storage) - 1
  float scale[3];  // du/dx = n / (hi - lo)
};

// u is rounded op by op, as the reference rounds it: a multiply and subtract
// contracted into one FMA can put a point on a cell face (u an exact integer
// there) in the cell below, which moves the interpolated value by an ulp but
// the points' gradient, which jumps across the face, by a whole step.  Every
// kernel rounds u this way, so a point lands in the same cell in all of them.
__device__ __forceinline__ void mtt_axes(const float xp[3], const float lo[3],
                                         const float ext[3], const int dims[3],
                                         const int32_t* size, MttAxes& a) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int nk = size != nullptr ? size[k] : dims[k];
    const float u =
        __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(xp[k], lo[k]), ext[k]), (float)nk), 0.5f);
    const float f0 = floorf(u);
    a.i0[k] = (int)f0;
    a.fr[k] = u - f0;
    a.n[k] = nk;
    // Clip to the logical size (as JAX does) and never past storage.
    a.hi[k] = min(nk, dims[k]) - 1;
    a.scale[k] = (float)nk / ext[k];
  }
}

// The 8 corners: flat row index into the (dims[0], dims[1], dims[2]) storage,
// weight with the zeros-padding validity folded in, and the validity bits
// (bit c set when corner c lies inside the logical grid).
__device__ __forceinline__ unsigned mtt_corners(const MttAxes& a, const int dims[3],
                                                int lin[8], float w[8]) {
  const int stride[3] = {dims[1] * dims[2], dims[2], 1};
  unsigned valid = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc = 1.f;
    bool ok = true;
    int li = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int bit = (c >> (2 - k)) & 1;
      const int ik = a.i0[k] + bit;
      ok = ok && ik >= 0 && ik < a.n[k];
      int ic = ik > a.hi[k] ? a.hi[k] : ik;
      ic = ic < 0 ? 0 : ic;
      li += ic * stride[k];
      wc *= bit ? a.fr[k] : 1.f - a.fr[k];
    }
    lin[c] = li;
    w[c] = ok ? wc : 0.f;
    valid |= (ok ? 1u : 0u) << c;
  }
  return valid;
}

// d w_c / d x_k for a valid corner c: the sign of the corner on axis k times
// the other two axes' lerp weights, times du_k/dx_k.
__device__ __forceinline__ float mtt_corner_dweight(const MttAxes& a, int c, int k) {
  float d = ((c >> (2 - k)) & 1) ? a.scale[k] : -a.scale[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j == k) continue;
    d *= ((c >> (2 - j)) & 1) ? a.fr[j] : 1.f - a.fr[j];
  }
  return d;
}

// Copy `elems` elements of a table to shared memory at dst (16-byte aligned),
// coalesced: 16-byte loads when src is 16-byte aligned and the table's bytes
// are a multiple of 16.  The caller synchronises the block after it.
template <typename T>
__device__ __forceinline__ void mtt_stage_table(const T* __restrict__ src, T* dst,
                                                long long elems, int tid, int nthreads) {
  const long long bytes = elems * (long long)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < (bytes >> 4); i += nthreads) d4[i] = __ldg(s4 + i);
  } else {
    for (long long i = tid; i < elems; i += nthreads) dst[i] = src[i];
  }
}

// A bf16 value's bits widened to float32 (exact: bf16 is float32's upper half).
__device__ __forceinline__ float mtt_widen(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

// Row r's element f: 32-bit offsets into a staged copy, 64-bit into a table.
template <bool STAGED, typename T>
__device__ __forceinline__ const T* mtt_row(const T* rows, int r, int F, int f) {
  return STAGED ? rows + (r * F + f) : rows + ((long long)r * F + f);
}

// One element as float32, from shared memory (STAGED) or through the
// read-only cache.
template <bool STAGED>
__device__ __forceinline__ float mtt_row_load(const float* p) {
  return STAGED ? *p : __ldg(p);
}

template <bool STAGED>
__device__ __forceinline__ float mtt_row_load(const __nv_bfloat16* p) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  return mtt_widen(STAGED ? *h : __ldg(h));
}

// Four elements as float32: one 16-byte load of float, one 8-byte load of bf16.
template <bool STAGED>
__device__ __forceinline__ float4 mtt_row_load4(const float* p) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  return STAGED ? *p4 : __ldg(p4);
}

template <bool STAGED>
__device__ __forceinline__ float4 mtt_row_load4(const __nv_bfloat16* p) {
  const uint2* p2 = reinterpret_cast<const uint2*>(p);
  const uint2 v = STAGED ? *p2 : __ldg(p2);
  // Little-endian: element 0 in the low half of the first word.
  return make_float4(mtt_widen(v.x & 0xffffu), __uint_as_float(v.x & 0xffff0000u),
                     mtt_widen(v.y & 0xffffu), __uint_as_float(v.y & 0xffff0000u));
}

// The F features of one point at one level, sum_c w[c] * rows[lin[c]] in
// float32, handed to sink.put4(f, float4) four at a time when vec4 (F % 4 == 0
// and the rows aligned to 4 elements), else to sink.put(f, float) one at a
// time.  rows is the staged copy in shared memory (STAGED) or the table in
// global memory, of float or bf16 elements (T).  FC > 0 is F known at compile
// time (rows of FC elements read 4 at a time, vec4 taken as set).
template <bool STAGED, int FC = 0, typename T, typename Sink>
__device__ __forceinline__ void mtt_lerp(const T* __restrict__ rows, const int lin[8],
                                         const float w[8], int F, bool vec4, Sink& sink) {
  if (FC > 0) {
#pragma unroll
    for (int f = 0; f < FC; f += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 v = mtt_row_load4<STAGED>(mtt_row<STAGED>(rows, lin[c], FC, f));
        acc.x = fmaf(w[c], v.x, acc.x);
        acc.y = fmaf(w[c], v.y, acc.y);
        acc.z = fmaf(w[c], v.z, acc.z);
        acc.w = fmaf(w[c], v.w, acc.w);
      }
      sink.put4(f, acc);
    }
  } else if (vec4) {
    for (int f = 0; f < F; f += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 v = mtt_row_load4<STAGED>(mtt_row<STAGED>(rows, lin[c], F, f));
        acc.x = fmaf(w[c], v.x, acc.x);
        acc.y = fmaf(w[c], v.y, acc.y);
        acc.z = fmaf(w[c], v.z, acc.z);
        acc.w = fmaf(w[c], v.w, acc.w);
      }
      sink.put4(f, acc);
    }
  } else {
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc = fmaf(w[c], mtt_row_load<STAGED>(mtt_row<STAGED>(rows, lin[c], F, f)), acc);
      }
      sink.put(f, acc);
    }
  }
}
