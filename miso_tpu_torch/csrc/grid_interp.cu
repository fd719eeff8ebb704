// Single-level trilinear interpolation of an (X, Y, Z, F) feature grid, and its
// backward: the grid's gradient and, when asked, the points' gradient.
//
// Replaces the Pallas TPU kernels of miso_tpu/ops/pallas_interp.py:
//   * forward:  _interp_kernel (launched by _tiled_interp_call behind
//     tiled_grid_interpolate and sorted_tiled_interp);
//   * backward: _interp_grad_kernel (launched by _tiled_interp_grad_call from
//     sorted_tiled_interp's backward _sti_bwd).
// The TPU kernels bin the points into (8, 16, 16)-cell tiles, sort them, and
// evaluate each 128-point chunk as a one-hot (128, 2688) matmul against a halo
// tile in VMEM, because the TPU cannot gather per point; their output comes
// back in tile-sorted order.  None of that layout is the function.  Both
// kernels here work in the caller's point order and compute each point's 8
// corners as ops/interp.py::corner_indices_and_weights does (mtt_grid.cuh).
//
// Two faults of the TPU op are not carried over: it pads F to 8 and breaks for
// F > 8 (here any F, rows read as float4 when
// F % 4 == 0), and its backward returns zeros for the points' gradient (here
// d out / d x through the lerp weights, with the zeros-padding validity kept):
//   d/dx_k = sum_c [corner c valid] (+-1) * (other axes' weights) * <g, row_c>
//            * n_k / (hi_k - lo_k).
//
// Forward: each point gathers its 8 rows (mtt_grid.cuh::mtt_lerp) in the
// caller's order, random over the table, so the L2's gather rate sets its
// pace, not device-memory bytes: 4 pairs of rows along axis 2, 8 float4
// requests in about 6 L2 sectors a point.  ops/tiled_interp.py::
// interp_forward_path picks one of three paths, from measurements on the
// H100 (PERF.md, scripts/interp_fwd_variants.py):
//   * a call of 2^19 points or more with a table that fits a block's share of
//     shared memory at 2 blocks an SM (the coarse ScanNet level, 42,336 B):
//     a persistent grid of 1024-thread blocks, each copying the table to its
//     shared memory once, then walking the points grid-stride;
//   * such a call with a larger table at F = 4 (the fine ScanNet level,
//     4.6 MB): a first kernel copies the table in pairs along axis 2, so that
//     a point's 4 pairs are 4 aligned 32-byte reads, 4 sectors (a bf16
//     table's, 16-byte reads); the copy, 9.2 MB written (4.6 MB in bf16), is
//     repaid at 1e6 points;
//   * every other call (the mesh path's 2^15-point batches and 2^18-point
//     lattice chunks, where a copy is not repaid, and wider rows, where a
//     pair spans several sectors anyway): one thread per point, from the
//     table in the H100's 50 MB L2 (small tables then stay in L1).
//
// Backward: one thread per point, as the forward, scatters w_c * g into the
// table with one float4 atomic per valid corner (red.global.add.v4.f32 on
// sm_90) and, when asked, gathers the 8 rows for the points' gradient.  The
// atomics are bounded by L2 atomic throughput and, where a level has few rows
// (the coarse ScanNet level: 2,646 rows, some 3,000 atomics each per 1e6
// points), by chains of same-address atomics, which the L2 serialises.  So a
// small table is privatised: block b adds into copy b % copies of the table,
// all of them L2-resident (ops/tiled_interp.py::interp_grad_copies gives up to
// 64 copies within 8 MB), and a second kernel sums the copies into the
// gradient, coalesced.  A table above the budget gets one copy, the gradient
// itself.
//
// Measured on the H100 and not kept (PERF.md): the TPU kernel's own
// shape, points binned by tile and summed per tile in shared memory.  The
// H100 runs shared-memory float atomics as compare-and-swap loops, slower
// than the L2's float4 atomics; tile-owned rows without atomics (a counting
// sort by cell in the block, then gathers or 8 parity passes) and a global
// sort by cell with a warp-level reduction of equal cells all cost more in
// sorting, barriers and index-driven point access than the atomics they
// save, at both ScanNet levels.
//
// Points-only backward (LM tracking: the SDF's spatial gradient with the grid
// frozen): one thread per point gathers its 8 rows as the forward does and
// writes d out / d x alone.  No table gradient is allocated or zeroed, no
// copies, no atomics; per point it reads x and g (12 + 4F B) and its rows,
// and writes 12 B.
//
// Slot-id mode (the atlas's per-point queries, ops/interp.py::
// grid_interpolate_per_point; no Pallas kernel of its own: the JAX package
// computes it as an XLA gather, and its arithmetic is _interp_kernel's and
// _interp_grad_kernel's corner math with three inputs taken from the point's
// slot).  The table is an atlas level's padded stacked storage, (S, dims[0],
// dims[1], dims[2], F); each point carries its slot id s (MttInterpArgs::slot),
// and mtt_axes reads lo, the extent and the logical size from slot s's rows
// of bound (S, 3, 2) and size (S, 3), and the corner rows are offset by
// s * slot_rows.  A point whose id lies outside [0, S) reads as zero
// features, adds nothing and gets a zero gradient.  The forward takes the L2
// path, one thread per point: the staged and paired paths copy one table,
// and a stacked level at the quad LiDAR widths (220 x 220 x 47 x 4 floats a
// slot, 36 MB) fits neither.  The backward scatters into the whole stacked
// storage, so padded rows and rows of other slots stay 0; its atomics spread
// over copies only where ops/tiled_interp.py::interp_grad_copies says so for
// the stacked table's size (never at those widths: one copy, the gradient).
// The points-only form serves alignment, where only the submap poses train.
// Its bound is bytes: per point the 8 corner rows of F floats, the point
// (12 B), its id (4 B) and its output (4F B), or for the backward the
// cotangent in place of the output and 12 B of points' gradient out.
//
// bf16 tables (grid.feature_dtype: bfloat16): every mode takes a table of
// __nv_bfloat16 elements (MttInterpArgs::bf16) as well as float.  Rows are read
// as stored and widened to float32 (mtt_grid.cuh), so the output, the points'
// gradient and every sum stay float32; the points and the cotangent are
// float32 whatever the table.  The backward accumulates the table's gradient
// in float32, in its L2-resident copies (at least one, MttGradPlan::partial,
// for a bf16 table), and the summing pass rounds it once into the bf16
// gradient: the function's gradient rounded to the table's type, not the JAX
// package's scatter-add, which rounds at every add in bf16.  The paired
// forward path pairs bf16 rows too (8 bytes each, a pair one 16-byte read):
// on an H100 (700 W) it took 0.0365 ms at the fine ScanNet level with 1e6
// points against 0.0446 from the unpaired bf16 table and 0.0437-0.0440 for
// the float32 pairs, in one run of scripts/interp_fwd_variants.py (PERF.md).
//
// What bounds the kernels on an H100: bytes.  Per point the forward reads x
// (12 B) and writes F floats; the backward reads x and g (12 + 4F B), writes
// the table once and, with the points' gradient, reads it once and writes
// 12 B per point.  At F = 4 that is 28 B per point, about 0.01 ms per 1e6
// points at 3.35 TB/s.  The scatter's atomics, not the bytes, are expected
// to cap the backward, whose float32 sums meet in an order that varies from
// run to run.

#include "mtt_grid.cuh"

#define MTT_INTERP_THREADS 256
#define MTT_STAGED_THREADS 1024
#define MTT_SUM_THREADS 256

// The forward's paths (ops/tiled_interp.py::FORWARD_PATHS).
#define MTT_FWD_L2 0
#define MTT_FWD_STAGED 1
#define MTT_FWD_PAIRS 2

struct MttInterpArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const void* grid;      // (dims[0], dims[1], dims[2], fdim), row-major, float or bf16
  const int32_t* size;   // (3,) logical size on the device, or null
  const float* g;        // backward: (n, fdim) cotangent of the output
  void* out;             // forward: (n, fdim) float; backward: the grid's gradient,
                         // of the grid's type (zeroed by the backward's entry point)
  float* gx;             // backward: (n, 3) points' gradient, or null
  long long n;
  int dims[3];
  int fdim;
  int vec4;              // rows read 4 elements at a time: fdim % 4 == 0, the
                         // grid aligned to 4 elements, out and g to 16 bytes
  const int32_t* slot;   // slot-id mode: (n,) each point's slot, or null (one grid)
  long long slot_rows;   // slot-id mode: rows of one slot, dims[0] * dims[1] * dims[2]
  int slots;             // slot-id mode: S; grid is (S, dims..., fdim), bound
                         // (S, 3, 2), size (S, 3), out of the backward (S, dims..., fdim)
  int bf16;              // 1: grid (and the backward's out) of __nv_bfloat16
};

// The backward's copies of the table (ops/tiled_interp.py::interp_grad_copies).
struct MttGradPlan {
  int copies;            // the table's float32 copies the atomics spread over
  float* partial;        // (copies, table) float32 scratch, zeroed here and then
                         // summed into the gradient; null (a float table and one
                         // copy only): the atomics go to the gradient itself
};

// Elements of the table (the stacked storage in slot-id mode).
__host__ __device__ __forceinline__ long long mtt_table_elems(const MttInterpArgs& a) {
  const long long one = (long long)a.dims[0] * a.dims[1] * a.dims[2] * a.fdim;
  return a.slot != nullptr ? one * a.slots : one;
}

// The point's axes; returns the first row of its grid in the table (0 for one
// grid, slot * slot_rows in slot-id mode), or -1 for a slot id outside
// [0, slots).
__device__ __forceinline__ long long mtt_point_axes(const MttInterpArgs& a, long long p,
                                                    MttAxes& ax) {
  const float* bound = a.bound;
  const int32_t* size = a.size;
  long long base = 0;
  if (a.slot != nullptr) {
    const int s = __ldg(a.slot + p);
    if (s < 0 || s >= a.slots) return -1;
    bound += 6 * s;
    size += 3 * s;
    base = (long long)s * a.slot_rows;
  }
  float lo[3], ext[3], xp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = bound[2 * k];
    ext[k] = bound[2 * k + 1] - lo[k];
    xp[k] = a.x[3 * p + k];
  }
  mtt_axes(xp, lo, ext, a.dims, size, ax);
  return base;
}

// Writes one point's features to its output row.
struct MttRowSink {
  float* o;
  __device__ __forceinline__ void put(int f, float v) { o[f] = v; }
  __device__ __forceinline__ void put4(int f, float4 v) {
    *reinterpret_cast<float4*>(o + f) = v;
  }
};

template <bool STAGED, int FC, typename T>
__device__ __forceinline__ void mtt_interp_point(const MttInterpArgs& a, const T* rows,
                                                 long long p) {
  MttAxes ax;
  const long long base = mtt_point_axes(a, p, ax);
  MttRowSink sink{static_cast<float*>(a.out) + p * a.fdim};
  if (base < 0) {
    for (int f = 0; f < a.fdim; ++f) sink.put(f, 0.f);
    return;
  }
  int lin[8];
  float w[8];
  mtt_corners(ax, a.dims, lin, w);
  mtt_lerp<STAGED, FC>(rows + base * a.fdim, lin, w, a.fdim, a.vec4 != 0, sink);
}

// A table left in L2: one thread per point.  FC: F at compile time (4, the
// paths' F, with rows read 4 elements at a time), or 0.  T: the table's type.
template <int FC, typename T>
__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_forward_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  mtt_interp_point<false, FC>(a, static_cast<const T*>(a.grid), p);
}

// A staged table: each block copies it to shared memory once, then walks the
// points grid-stride.
template <int FC, typename T>
__global__ void __launch_bounds__(MTT_STAGED_THREADS)
grid_interp_forward_staged_kernel(const __grid_constant__ MttInterpArgs a) {
  extern __shared__ float4 smem4[];
  T* table = reinterpret_cast<T*>(smem4);
  mtt_stage_table(static_cast<const T*>(a.grid), table,
                  (long long)a.dims[0] * a.dims[1] * a.dims[2] * a.fdim, threadIdx.x,
                  MTT_STAGED_THREADS);
  __syncthreads();
  for (long long p = (long long)blockIdx.x * MTT_STAGED_THREADS + threadIdx.x; p < a.n;
       p += (long long)gridDim.x * MTT_STAGED_THREADS) {
    mtt_interp_point<true, FC>(a, table, p);
  }
}

// A table left in L2, read in pairs (F = 4): row r of the copy holds storage
// rows r and r + 1 along axis 2 (r again where r + 1 passes the last row a
// corner can index there, as a corner clips), so the two corners of a pair
// are one aligned read, one L2 sector (32 bytes of float, 16 of bf16), where
// the table itself gives 1.5 on average.  The copy is made by a first kernel
// on every call.  mtt_pair_pack writes pair r from rows r and r1;
// mtt_pair_load reads pair `row` as two float4 rows (the tag's type is the
// table's).
__device__ __forceinline__ void mtt_pair_pack(const float* grid, long long r, long long r1,
                                              void* pairs) {
  const float4* g4 = reinterpret_cast<const float4*>(grid);
  float4* p4 = static_cast<float4*>(pairs);
  p4[2 * r] = __ldg(g4 + r);
  p4[2 * r + 1] = __ldg(g4 + r1);
}

__device__ __forceinline__ void mtt_pair_pack(const __nv_bfloat16* grid, long long r,
                                              long long r1, void* pairs) {
  const uint2* g2 = reinterpret_cast<const uint2*>(grid);
  const uint2 lo = __ldg(g2 + r), hi = __ldg(g2 + r1);
  static_cast<uint4*>(pairs)[r] = make_uint4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void mtt_pair_load(const float*, const void* pairs, long long row,
                                              float4& v0, float4& v1) {
  const float4* p4 = static_cast<const float4*>(pairs);
  v0 = __ldg(p4 + 2 * row);
  v1 = __ldg(p4 + 2 * row + 1);
}

__device__ __forceinline__ void mtt_pair_load(const __nv_bfloat16*, const void* pairs,
                                              long long row, float4& v0, float4& v1) {
  const uint4 q = __ldg(static_cast<const uint4*>(pairs) + row);
  v0 = make_float4(mtt_widen(q.x & 0xffffu), __uint_as_float(q.x & 0xffff0000u),
                   mtt_widen(q.y & 0xffffu), __uint_as_float(q.y & 0xffff0000u));
  v1 = make_float4(mtt_widen(q.z & 0xffffu), __uint_as_float(q.z & 0xffff0000u),
                   mtt_widen(q.w & 0xffffu), __uint_as_float(q.w & 0xffff0000u));
}

template <typename T>
__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_pair_pack_kernel(const __grid_constant__ MttInterpArgs a, void* __restrict__ pairs) {
  const long long r = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  const long long rows = (long long)a.dims[0] * a.dims[1] * a.dims[2];
  if (r >= rows) return;
  const int z = (int)(r % a.dims[2]);
  const int z_hi = min(a.size != nullptr ? a.size[2] : a.dims[2], a.dims[2]) - 1;
  mtt_pair_pack(static_cast<const T*>(a.grid), r, z < z_hi ? r + 1 : r, pairs);
}

template <typename T>
__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_forward_pairs_kernel(const __grid_constant__ MttInterpArgs a,
                                 const void* __restrict__ pairs) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  // Axis 2: the pair at the lower corner, clipped; the weights of its rows.
  // A lower corner at -1 clips to row 0, which is then the upper corner.
  const int i0 = ax.i0[2];
  const int zp = i0 < 0 ? 0 : (i0 > ax.hi[2] ? ax.hi[2] : i0);
  const float wz0 = (i0 >= 0 && i0 < ax.n[2]) ? 1.f - ax.fr[2] : 0.f;
  const float wz1 = (i0 + 1 >= 0 && i0 + 1 < ax.n[2]) ? ax.fr[2] : 0.f;
  const float e0 = i0 < 0 ? wz1 : wz0, e1 = i0 < 0 ? 0.f : wz1;
  float4 v[8];
  float wxy[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // corners of axes 0 and 1, axis 0 slowest
    float wc = 1.f;
    bool ok = true;
    int ic[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int bit = (c >> (1 - k)) & 1;
      const int ik = ax.i0[k] + bit;
      ok = ok && ik >= 0 && ik < ax.n[k];
      ic[k] = ik > ax.hi[k] ? ax.hi[k] : (ik < 0 ? 0 : ik);
      wc *= bit ? ax.fr[k] : 1.f - ax.fr[k];
    }
    const long long row = ((long long)ic[0] * a.dims[1] + ic[1]) * a.dims[2] + zp;
    mtt_pair_load(static_cast<const T*>(nullptr), pairs, row, v[2 * c], v[2 * c + 1]);
    wxy[c] = ok ? wc : 0.f;
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float w0 = wxy[c] * e0, w1 = wxy[c] * e1;
    acc.x = fmaf(w1, v[2 * c + 1].x, fmaf(w0, v[2 * c].x, acc.x));
    acc.y = fmaf(w1, v[2 * c + 1].y, fmaf(w0, v[2 * c].y, acc.y));
    acc.z = fmaf(w1, v[2 * c + 1].z, fmaf(w0, v[2 * c].z, acc.z));
    acc.w = fmaf(w1, v[2 * c + 1].w, fmaf(w0, v[2 * c].w, acc.w));
  }
  static_cast<float4*>(a.out)[p] = acc;
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mtt_atomic_add4(float* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst + 0, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// d out / d x of one point: <g, row_c> of each valid corner through the
// weights' derivatives.
template <typename T>
__device__ __forceinline__ void mtt_points_grad(const MttInterpArgs& a, const T* rows,
                                                const MttAxes& ax, unsigned valid,
                                                const int lin[8], const float* gp, float* gxp) {
  const int F = a.fdim;
  float dot[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) dot[c] = 0.f;
  if (a.vec4) {
    for (int f = 0; f < F; f += 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gp + f));
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (!((valid >> c) & 1u)) continue;
        const float4 r = mtt_row_load4<false>(rows + (long long)lin[c] * F + f);
        dot[c] = fmaf(gv.x, r.x, fmaf(gv.y, r.y, fmaf(gv.z, r.z, fmaf(gv.w, r.w, dot[c]))));
      }
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const float gf = __ldg(gp + f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if ((valid >> c) & 1u) {
          dot[c] = fmaf(gf, mtt_row_load<false>(rows + (long long)lin[c] * F + f), dot[c]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if ((valid >> c) & 1u) s = fmaf(mtt_corner_dweight(ax, c, k), dot[c], s);
    }
    gxp[k] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_backward_kernel(const __grid_constant__ MttInterpArgs a,
                            const __grid_constant__ MttGradPlan pl) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  const long long base = mtt_point_axes(a, p, ax);
  if (base < 0) {
    if (a.gx != nullptr) a.gx[3 * p] = a.gx[3 * p + 1] = a.gx[3 * p + 2] = 0.f;
    return;
  }
  int lin[8];
  float w[8];
  const unsigned valid = mtt_corners(ax, a.dims, lin, w);
  const int F = a.fdim;
  const float* gp = a.g + p * F;
  float* table = pl.partial != nullptr
                     ? pl.partial + (long long)(blockIdx.x % pl.copies) * mtt_table_elems(a)
                     : static_cast<float*>(a.out);
  table += base * F;
  // The grid's gradient.  An invalid corner adds nothing (its weight is 0).
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!((valid >> c) & 1u)) continue;
    float* dst = table + (long long)lin[c] * F;
    if (a.vec4) {
      for (int f = 0; f < F; f += 4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gp + f));
        mtt_atomic_add4(dst + f, make_float4(w[c] * gv.x, w[c] * gv.y, w[c] * gv.z,
                                             w[c] * gv.w));
      }
    } else {
      for (int f = 0; f < F; ++f) atomicAdd(dst + f, w[c] * __ldg(gp + f));
    }
  }
  if (a.gx != nullptr) {
    mtt_points_grad(a, static_cast<const T*>(a.grid) + base * F, ax, valid, lin, gp,
                    a.gx + 3 * p);
  }
}

template <typename T>
__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_points_grad_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  const long long base = mtt_point_axes(a, p, ax);
  if (base < 0) {
    a.gx[3 * p] = a.gx[3 * p + 1] = a.gx[3 * p + 2] = 0.f;
    return;
  }
  int lin[8];
  float w[8];
  const unsigned valid = mtt_corners(ax, a.dims, lin, w);
  mtt_points_grad(a, static_cast<const T*>(a.grid) + base * a.fdim, ax, valid, lin,
                  a.g + p * a.fdim, a.gx + 3 * p);
}

// Store a summed gradient in the table's type: as it is, or rounded once to
// bf16 (to nearest even).
__device__ __forceinline__ void mtt_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void mtt_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void mtt_store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void mtt_store4(__nv_bfloat16* p, float4 v) {
  uint2 w;
  w.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  w.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16);
  *reinterpret_cast<uint2*>(p) = w;
}

// The gradient: the sum of the copies, element by element (4 at a time when
// the table's length allows), in float32, stored in the table's type T.
template <typename T>
__global__ void __launch_bounds__(MTT_SUM_THREADS)
grid_grad_sum_copies_kernel(const __grid_constant__ MttInterpArgs a,
                            const __grid_constant__ MttGradPlan pl, long long elems) {
  const long long i = (long long)blockIdx.x * MTT_SUM_THREADS + threadIdx.x;
  T* out = static_cast<T*>(a.out);
  if (elems % 4 == 0) {
    if (4 * i >= elems) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < pl.copies; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(pl.partial + k * elems) + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    mtt_store4(out + 4 * i, s);
  } else {
    if (i >= elems) return;
    float s = 0.f;
    for (int k = 0; k < pl.copies; ++k) s += __ldg(pl.partial + k * elems + i);
    mtt_store(out + i, s);
  }
}

static int mtt_interp_check(const MttInterpArgs& a) {
  if (a.fdim < 1 || a.n < 0 || a.dims[0] < 1 || a.dims[1] < 1 || a.dims[2] < 1 ||
      (a.vec4 && a.fdim % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.slot != nullptr &&
      (a.slots < 1 || a.size == nullptr ||
       a.slot_rows != (long long)a.dims[0] * a.dims[1] * a.dims[2])) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

#define MTT_TRY(expr)                            \
  do {                                           \
    const cudaError_t mtt_e = (expr);            \
    if (mtt_e != cudaSuccess) return (int)mtt_e; \
  } while (0)

template <typename T>
static int mtt_grad_launch(const MttInterpArgs& a, const MttGradPlan& pl,
                           cudaStream_t s) {
  const long long elems = mtt_table_elems(a);
  const bool scratch = pl.partial != nullptr;
  if (pl.copies < 1 || (pl.copies > 1 && !scratch) || (a.bf16 && !scratch) ||
      (a.n > 0 && a.g == nullptr) || (reinterpret_cast<uintptr_t>(a.out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  void* zeroed = scratch ? static_cast<void*>(pl.partial) : a.out;
  MTT_TRY(cudaMemsetAsync(zeroed, 0, (size_t)pl.copies * elems * sizeof(float), s));
  if (a.n > 0) {
    const long long blocks = (a.n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid_interp_backward_kernel<T><<<(unsigned)blocks, MTT_INTERP_THREADS, 0, s>>>(a, pl);
    MTT_TRY(cudaGetLastError());
  }
  if (scratch) {
    const long long work = elems % 4 == 0 ? elems / 4 : elems;
    grid_grad_sum_copies_kernel<T>
        <<<(unsigned)((work + MTT_SUM_THREADS - 1) / MTT_SUM_THREADS), MTT_SUM_THREADS, 0,
           s>>>(a, pl, elems);
    MTT_TRY(cudaGetLastError());
  }
  return 0;
}

// The forward's launches for a table of type T (see mtt_grid_interp_forward).
template <typename T>
static int mtt_forward_launch(const MttInterpArgs* a, int path, void* pairs, int device,
                              cudaStream_t s) {
  const bool f4 = a->fdim == 4 && a->vec4;
  const long long blocks = (a->n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (path == MTT_FWD_L2) {
    (f4 ? grid_interp_forward_kernel<4, T> : grid_interp_forward_kernel<0, T>)
        <<<(unsigned)blocks, MTT_INTERP_THREADS, 0, s>>>(*a);
    return (int)cudaGetLastError();
  }
  const long long rows = (long long)a->dims[0] * a->dims[1] * a->dims[2];
  if (path == MTT_FWD_PAIRS) {
    grid_interp_pair_pack_kernel<T><<<(unsigned)((rows + MTT_INTERP_THREADS - 1) /
                                                 MTT_INTERP_THREADS),
                                      MTT_INTERP_THREADS, 0, s>>>(*a, pairs);
    MTT_TRY(cudaGetLastError());
    grid_interp_forward_pairs_kernel<T>
        <<<(unsigned)blocks, MTT_INTERP_THREADS, 0, s>>>(*a, pairs);
    return (int)cudaGetLastError();
  }
  if (path != MTT_FWD_STAGED) return (int)cudaErrorInvalidValue;
  void (*kernel)(const MttInterpArgs) =
      f4 ? grid_interp_forward_staged_kernel<4, T> : grid_interp_forward_staged_kernel<0, T>;
  const long long bytes = rows * a->fdim * (long long)sizeof(T);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const int smem = (int)(((bytes + 15) / 16) * 16);
  MTT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int sms = 0, occ = 0;
  MTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  MTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, MTT_STAGED_THREADS,
                                                        smem));
  if (occ < 1) occ = 1;
  const long long tiles = (a->n + MTT_STAGED_THREADS - 1) / MTT_STAGED_THREADS;
  const long long wave = (long long)sms * occ;
  kernel<<<(unsigned)(tiles < wave ? tiles : wave), MTT_STAGED_THREADS, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" {

// Both launch on `stream` of CUDA device `device` and return the first CUDA
// error of their launches (0 = ok).  Neither synchronises nor allocates.  This
// library links its own CUDA runtime, whose current device is not PyTorch's:
// each sets it from the caller's tensors.
//
// In slot-id mode (a->slot set) each takes the stacked storage and per-slot
// bounds and sizes; the forward then takes MTT_FWD_L2 only.
//
// The forward takes the path ops/tiled_interp.py::interp_forward_path picks:
// MTT_FWD_L2, one thread per point from the table; MTT_FWD_STAGED, the table
// copied to each block's shared memory, one wave of blocks; MTT_FWD_PAIRS
// (F = 4), the table copied
// in pairs into `pairs` (8 * rows elements of the table's type, 16-byte
// aligned), then one thread per point.
int mtt_grid_interp_forward(const MttInterpArgs* a, int path, void* pairs, int device,
                            void* stream) {
  if (a->g != nullptr || a->gx != nullptr) return (int)cudaErrorInvalidValue;
  const int bad = mtt_interp_check(*a);
  if (bad != 0) return bad;
  if (path == MTT_FWD_PAIRS && (a->fdim != 4 || !a->vec4 || pairs == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->slot != nullptr && path != MTT_FWD_L2) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const cudaStream_t s = (cudaStream_t)stream;
  return a->bf16 ? mtt_forward_launch<__nv_bfloat16>(a, path, pairs, device, s)
                 : mtt_forward_launch<float>(a, path, pairs, device, s);
}

// Zeroes the copies, scatters into them and, with scratch copies
// (plan->partial), sums them into the grid's gradient (a->out) in the grid's
// type: a memset and one kernel, or a memset and two.  With no points a->g and a->gx may be null (an empty tensor has no
// storage).
int mtt_grid_interp_backward(const MttInterpArgs* a, const MttGradPlan* plan, int device,
                             void* stream) {
  const int bad = mtt_interp_check(*a);
  if (bad != 0) return bad;
  MTT_TRY(cudaSetDevice(device));
  return a->bf16 ? mtt_grad_launch<__nv_bfloat16>(*a, *plan, (cudaStream_t)stream)
                 : mtt_grad_launch<float>(*a, *plan, (cudaStream_t)stream);
}

// The points' gradient alone (a->gx), the table's not asked for: a->out must
// be null.  One kernel, no memset.
int mtt_grid_interp_points_grad(const MttInterpArgs* a, int device, void* stream) {
  const int bad = mtt_interp_check(*a);
  if (bad != 0) return bad;
  if (a->out != nullptr || (a->n > 0 && (a->g == nullptr || a->gx == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const long long blocks = (a->n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (a->bf16) {
    grid_interp_points_grad_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, MTT_INTERP_THREADS, 0, (cudaStream_t)stream>>>(*a);
  } else {
    grid_interp_points_grad_kernel<float>
        <<<(unsigned)blocks, MTT_INTERP_THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
