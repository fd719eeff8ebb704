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
// back in tile-sorted order.  None of that is the function.  Here one thread
// handles one point in the caller's order: it computes its 8 corners as
// ops/interp.py::corner_indices_and_weights does (mtt_grid.cuh) and gathers
// the rows straight from the grid, which sits in the H100's 50 MB L2 (the fine
// ScanNet level is 4.6 MB).
//
// Two faults of the TPU op are not carried over: it pads F to 8 and breaks for
// F > 8 (here any F, rows read as float4 when F % 4 == 0), and its backward
// returns zeros for the points' gradient (here d out / d x through the lerp
// weights, with the zeros-padding validity kept).
//
// Backward: the grid's gradient is scattered with atomicAdd of w_c * g into a
// zeroed table (float4 atomics on sm_90 when F % 4 == 0), so its sum order
// varies from run to run; the points' gradient needs no atomics:
//   d/dx_k = sum_c [corner c valid] (+-1) * (other axes' weights) * <g, row_c>
//            * n_k / (hi_k - lo_k).
//
// What bounds them on an H100: bytes.  Per point the forward reads x (12 B)
// and writes F floats; the backward reads x and g (12 + 4F B) and scatters
// into the table once per corner; the table is read or written once (counted
// once in the bound).  At F = 4 that is 28 B per point, about 0.01 ms per 1e6
// points at 3.35 TB/s, while the lerp is 2 * 8 * F flops per point.  The
// corner gathers and the scatter atomics hit L2, not device memory, so L2
// latency and atomic throughput, not device-memory bandwidth, are expected to
// cap both kernels.

#include "mtt_grid.cuh"

#define MTT_INTERP_THREADS 256

struct MttInterpArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  const float* g;        // backward: (n, fdim) cotangent of the output
  float* out;            // forward: (n, fdim); backward: the grid's gradient,
                         // zeroed by the caller
  float* gx;             // backward: (n, 3) points' gradient, or null
  long long n;
  int dims[3];
  int fdim;
  int vec4;              // rows as float4: fdim % 4 == 0, 16-byte aligned
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
  mtt_axes(xp, lo, ext, a.dims, a.size, ax);
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

__global__ void __launch_bounds__(MTT_INTERP_THREADS)
grid_interp_backward_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long p = (long long)blockIdx.x * MTT_INTERP_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  int lin[8];
  float w[8];
  const unsigned valid = mtt_corners(ax, a.dims, lin, w);
  const int F = a.fdim;
  const float* gp = a.g + p * F;

  // The grid's gradient.  An invalid corner adds nothing (its weight is 0).
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!((valid >> c) & 1u)) continue;
    float* dst = a.out + (long long)lin[c] * F;
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
  if (a.gx == nullptr) return;

  // The points' gradient: <g, row_c> per valid corner, then the weights'
  // derivatives along each axis.
  float dot[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float s = 0.f;
    if ((valid >> c) & 1u) {
      const float* row = a.grid + (long long)lin[c] * F;
      for (int f = 0; f < F; ++f) s = fmaf(__ldg(gp + f), __ldg(row + f), s);
    }
    dot[c] = s;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if ((valid >> c) & 1u) s = fmaf(mtt_corner_dweight(ax, c, k), dot[c], s);
    }
    a.gx[3 * p + k] = s;
  }
}

static int mtt_interp_check(const MttInterpArgs& a) {
  if (a.fdim < 1 || a.n < 0 || a.dims[0] < 1 || a.dims[1] < 1 || a.dims[2] < 1 ||
      (a.vec4 && a.fdim % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

static int mtt_interp_launch(void (*kernel)(const MttInterpArgs), const MttInterpArgs& a,
                             int device, void* stream) {
  const int bad = mtt_interp_check(a);
  if (bad != 0) return bad;
  if (a.n == 0) return 0;
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it from the caller's tensors.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.n + MTT_INTERP_THREADS - 1) / MTT_INTERP_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MTT_INTERP_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// Both launch on `stream` of CUDA device `device` and return cudaGetLastError()
// of the launch (0 = ok).  Neither synchronises nor allocates.
int mtt_grid_interp_forward(const MttInterpArgs* a, int device, void* stream) {
  if (a->g != nullptr || a->gx != nullptr) return (int)cudaErrorInvalidValue;
  return mtt_interp_launch(grid_interp_forward_kernel, *a, device, stream);
}

int mtt_grid_interp_backward(const MttInterpArgs* a, int device, void* stream) {
  if (a->g == nullptr) return (int)cudaErrorInvalidValue;
  return mtt_interp_launch(grid_interp_backward_kernel, *a, device, stream);
}

}  // extern "C"
