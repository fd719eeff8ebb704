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
// Forward: one thread per point gathers its 8 rows straight from the grid,
// which sits in the H100's 50 MB L2 (the fine ScanNet level is 4.6 MB).
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
// What bounds the kernels on an H100: bytes.  Per point the forward reads x
// (12 B) and writes F floats; the backward reads x and g (12 + 4F B), writes
// the table once and, with the points' gradient, reads it once and writes
// 12 B per point.  At F = 4 that is 28 B per point, about 0.01 ms per 1e6
// points at 3.35 TB/s.  The scatter's atomics, not the bytes, are expected
// to cap the backward, whose float32 sums meet in an order that varies from
// run to run.

#include "mtt_grid.cuh"

#define MTT_INTERP_THREADS 256
#define MTT_SUM_THREADS 256

struct MttInterpArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  const float* g;        // backward: (n, fdim) cotangent of the output
  float* out;            // forward: (n, fdim); backward: the grid's gradient
                         // (zeroed by the backward's entry point)
  float* gx;             // backward: (n, 3) points' gradient, or null
  long long n;
  int dims[3];
  int fdim;
  int vec4;              // rows as float4: fdim % 4 == 0, 16-byte aligned
};

// The backward's copies of the table (ops/tiled_interp.py::interp_grad_copies).
struct MttGradPlan {
  int copies;            // 1: the atomics go to the gradient itself
  float* partial;        // copies > 1: (copies, table) scratch, zeroed here
};

__device__ __forceinline__ void mtt_point_axes(const MttInterpArgs& a, long long p,
                                               MttAxes& ax) {
  float lo[3], ext[3], xp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.bound[2 * k];
    ext[k] = a.bound[2 * k + 1] - lo[k];
    xp[k] = a.x[3 * p + k];
  }
  mtt_axes(xp, lo, ext, a.dims, a.size, ax, /*round_each_op=*/true);
}

__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_forward_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  int lin[8];
  float w[8];
  mtt_corners(ax, a.dims, lin, w);
  const int F = a.fdim;
  float* o = a.out + p * F;
  if (a.vec4) {
    for (int f = 0; f < F; f += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(a.grid + (long long)lin[c] * F + f));
        acc.x = fmaf(w[c], v.x, acc.x);
        acc.y = fmaf(w[c], v.y, acc.y);
        acc.z = fmaf(w[c], v.z, acc.z);
        acc.w = fmaf(w[c], v.w, acc.w);
      }
      *reinterpret_cast<float4*>(o + f) = acc;
    }
  } else {
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc = fmaf(w[c], __ldg(a.grid + (long long)lin[c] * F + f), acc);
      }
      o[f] = acc;
    }
  }
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
__device__ __forceinline__ void mtt_points_grad(const MttInterpArgs& a, const MttAxes& ax,
                                                unsigned valid, const int lin[8],
                                                const float* gp, float* gxp) {
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
        const float4 r =
            __ldg(reinterpret_cast<const float4*>(a.grid + (long long)lin[c] * F + f));
        dot[c] = fmaf(gv.x, r.x, fmaf(gv.y, r.y, fmaf(gv.z, r.z, fmaf(gv.w, r.w, dot[c]))));
      }
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const float gf = __ldg(gp + f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if ((valid >> c) & 1u) dot[c] = fmaf(gf, __ldg(a.grid + (long long)lin[c] * F + f), dot[c]);
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

__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_backward_kernel(const __grid_constant__ MttInterpArgs a,
                            const __grid_constant__ MttGradPlan pl) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  int lin[8];
  float w[8];
  const unsigned valid = mtt_corners(ax, a.dims, lin, w);
  const int F = a.fdim;
  const float* gp = a.g + p * F;
  float* table = a.out;
  if (pl.copies > 1) {
    table = pl.partial +
            (long long)(blockIdx.x % pl.copies) * a.dims[0] * a.dims[1] * a.dims[2] * F;
  }
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
  if (a.gx != nullptr) mtt_points_grad(a, ax, valid, lin, gp, a.gx + 3 * p);
}

// The gradient: the sum of the copies, element by element (float4 when the
// table's length allows).
__global__ void __launch_bounds__(MTT_SUM_THREADS)
grid_grad_sum_copies_kernel(const __grid_constant__ MttInterpArgs a,
                            const __grid_constant__ MttGradPlan pl, long long elems) {
  const long long i = (long long)blockIdx.x * MTT_SUM_THREADS + threadIdx.x;
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
    reinterpret_cast<float4*>(a.out)[i] = s;
  } else {
    if (i >= elems) return;
    float s = 0.f;
    for (int k = 0; k < pl.copies; ++k) s += __ldg(pl.partial + k * elems + i);
    a.out[i] = s;
  }
}

static int mtt_interp_check(const MttInterpArgs& a) {
  if (a.fdim < 1 || a.n < 0 || a.dims[0] < 1 || a.dims[1] < 1 || a.dims[2] < 1 ||
      (a.vec4 && a.fdim % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

#define MTT_TRY(expr)                            \
  do {                                           \
    const cudaError_t mtt_e = (expr);            \
    if (mtt_e != cudaSuccess) return (int)mtt_e; \
  } while (0)

static int mtt_grad_launch(const MttInterpArgs& a, const MttGradPlan& pl,
                           cudaStream_t s) {
  const long long elems = (long long)a.dims[0] * a.dims[1] * a.dims[2] * a.fdim;
  if (pl.copies < 1 || (pl.copies > 1 && pl.partial == nullptr) ||
      (a.n > 0 && a.g == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  float* zeroed = pl.copies > 1 ? pl.partial : a.out;
  MTT_TRY(cudaMemsetAsync(zeroed, 0, (size_t)pl.copies * elems * sizeof(float), s));
  if (a.n > 0) {
    const long long blocks = (a.n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid_interp_backward_kernel<<<(unsigned)blocks, MTT_INTERP_THREADS, 0, s>>>(a, pl);
    MTT_TRY(cudaGetLastError());
  }
  if (pl.copies > 1) {
    const long long work = elems % 4 == 0 ? elems / 4 : elems;
    grid_grad_sum_copies_kernel<<<(unsigned)((work + MTT_SUM_THREADS - 1) / MTT_SUM_THREADS),
                                  MTT_SUM_THREADS, 0, s>>>(a, pl, elems);
    MTT_TRY(cudaGetLastError());
  }
  return 0;
}

extern "C" {

// Both launch on `stream` of CUDA device `device` and return the first CUDA
// error of their launches (0 = ok).  Neither synchronises nor allocates.  This
// library links its own CUDA runtime, whose current device is not PyTorch's:
// each sets it from the caller's tensors.
int mtt_grid_interp_forward(const MttInterpArgs* a, int device, void* stream) {
  if (a->g != nullptr || a->gx != nullptr) return (int)cudaErrorInvalidValue;
  const int bad = mtt_interp_check(*a);
  if (bad != 0) return bad;
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const long long blocks = (a->n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_interp_forward_kernel<<<(unsigned)blocks, MTT_INTERP_THREADS, 0,
                               (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Zeroes the copies, scatters into them and, with more than one, sums them
// into the grid's gradient (a->out): a memset and one kernel, or a memset and
// two.  With no points a->g and a->gx may be null (an empty tensor has no
// storage).
int mtt_grid_interp_backward(const MttInterpArgs* a, const MttGradPlan* plan, int device,
                             void* stream) {
  const int bad = mtt_interp_check(*a);
  if (bad != 0) return bad;
  MTT_TRY(cudaSetDevice(device));
  return mtt_grad_launch(*a, *plan, (cudaStream_t)stream);
}

}  // extern "C"
