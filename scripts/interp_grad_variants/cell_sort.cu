// The interp grad kernel as a global sort by cell and a warp-level
// reduction, for the H100.  Built and timed against the shipped kernel
// (miso_tpu_torch/csrc/grid_interp.cu) by scripts/interp_grad_variants.py;
// not shipped (PERF.md, Findings).
//
// Points of one floor cell share their 8 corner rows, so their sums can meet
// before they reach L2 (size = None only):
//   1. bin:     each point's key is its floor cell on a (dims + 1)^3 lattice of
//               cells (floor(u) = -1 included); points with no valid corner
//               are dropped (their points' gradient is 0); a counting sort
//               (per-key counts with global atomics, a scan of the counts in
//               segments of 1024 keys, a scatter of int32 point indices) puts
//               the rest in cell order;
//   2. reduce:  one thread per sorted point computes w_c * g for its 8 corners,
//               four features at a time; the lanes of a warp that share a
//               cell (a run of equal keys) add theirs up with shuffles, and
//               the last lane of each run sends one global float4 atomic per
//               valid corner (scalar ones when not vec4);
//   3. points' gradient (gx != null): a kernel of its own, one thread per
//               sorted point, takes <g, row_c> from the table.

#include "mtt_grid.cuh"

#define MTT_BIN_THREADS 256
#define MTT_BIN_PPT 8          // points per thread in the binning kernels
#define MTT_SCAN_THREADS 1024
#define MTT_KEY_SEGMENT 1024   // keys per segment of the counts' scan
#define MTT_RED_THREADS 256

struct MttInterpArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  const float* g;        // (n, fdim) cotangent of the output
  float* out;            // the grid's gradient (zeroed by the entry point)
  float* gx;             // (n, 3) points' gradient, or null
  long long n;
  int dims[3];
  int fdim;
  int vec4;              // rows as float4: fdim % 4 == 0, 16-byte aligned
};

// The sort's sizes and scratch (scripts/interp_grad_variants.py allocates them).
struct MttGradPlan {
  int cells[3];          // dims + 1: floor cells -1 .. dims - 1 per axis
  int segments;          // ceil(cells[0] * cells[1] * cells[2] / MTT_KEY_SEGMENT)
  int32_t* key;          // (n,) each point's cell, -1 when it is not sorted
  int32_t* sorted;       // (n,) point indices in cell order
  int32_t* count;        // (segments * MTT_KEY_SEGMENT,) per cell: counts, then
                         // offsets within the segment, then cursors
  int32_t* seg_start;    // (segments + 1,) first sorted slot of each segment
};

__device__ __forceinline__ void mtt_axes_of(const MttInterpArgs& a, const float xp[3],
                                            MttAxes& ax) {
  float lo[3], ext[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.bound[2 * k];
    ext[k] = a.bound[2 * k + 1] - lo[k];
  }
  mtt_axes(xp, lo, ext, a.dims, a.size, ax);
}

__device__ __forceinline__ void mtt_point_axes(const MttInterpArgs& a, long long p,
                                               MttAxes& ax) {
  const float xp[3] = {a.x[3 * p], a.x[3 * p + 1], a.x[3 * p + 2]};
  mtt_axes_of(a, xp, ax);
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

// True when at least one of the point's 8 corners lies in the logical grid:
// on every axis floor(u) or floor(u) + 1 is in [0, n).
__device__ __forceinline__ bool mtt_any_corner_valid(const MttAxes& ax) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i0 = ax.i0[k], n = ax.n[k];
    ok = ok && ((i0 >= 0 && i0 < n) || (i0 >= -1 && i0 < n - 1));
  }
  return ok;
}

// The point's floor cell on the (dims + 1)^3 lattice.
__device__ __forceinline__ int mtt_cell_key(const MttAxes& ax, const MttGradPlan& pl) {
  return ((ax.i0[0] + 1) * pl.cells[1] + (ax.i0[1] + 1)) * pl.cells[2] + (ax.i0[2] + 1);
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

// Exclusive prefix sum of v[0, len) in place by one whole block of
// blockDim.x threads (a multiple of 32); each thread sums a contiguous run.
// Returns the total to every thread.
__device__ int mtt_block_exclusive_scan(int* v, int len) {
  __shared__ int wsum[32];
  __shared__ int total;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + nt - 1) / nt;
  const int lo = min(tid * per, len), hi = min(lo + per, len);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += v[i];
  int inc = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int wv = lane < nt / 32 ? wsum[lane] : 0;
    int wi = wv;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < nt / 32) wsum[lane] = wi - wv;
    if (lane == 31) total = wi;
  }
  __syncthreads();
  int run = wsum[warp] + inc - own;
  for (int i = lo; i < hi; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// Sort 1: each point's cell key and the per-cell counts.  A point with no
// valid corner gets key -1 and a zero points' gradient.
__global__ void __launch_bounds__(MTT_BIN_THREADS)
grid_grad_bin_kernel(const __grid_constant__ MttInterpArgs a,
                     const __grid_constant__ MttGradPlan pl) {
  const long long base =
      (long long)blockIdx.x * (MTT_BIN_THREADS * MTT_BIN_PPT) + threadIdx.x;
  // All loads first: the points are independent, and their latency overlaps.
  float xs[MTT_BIN_PPT][3];
#pragma unroll
  for (int j = 0; j < MTT_BIN_PPT; ++j) {
    const long long p = base + (long long)j * MTT_BIN_THREADS;
#pragma unroll
    for (int k = 0; k < 3; ++k) xs[j][k] = p < a.n ? a.x[3 * p + k] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < MTT_BIN_PPT; ++j) {
    const long long p = base + (long long)j * MTT_BIN_THREADS;
    if (p >= a.n) continue;
    MttAxes ax;
    mtt_axes_of(a, xs[j], ax);
    int key = -1;
    if (!mtt_any_corner_valid(ax)) {
      if (a.gx != nullptr) {
        a.gx[3 * p] = 0.f;
        a.gx[3 * p + 1] = 0.f;
        a.gx[3 * p + 2] = 0.f;
      }
    } else {
      key = mtt_cell_key(ax, pl);
      atomicAdd(&pl.count[key], 1);
    }
    pl.key[p] = key;
  }
}

// Sort 2 (a warp per segment of MTT_KEY_SEGMENT keys): the exclusive prefix
// of the counts within the segment, in place, and the segment's total into
// seg_start.
__global__ void __launch_bounds__(MTT_BIN_THREADS)
grid_grad_segscan_kernel(const __grid_constant__ MttGradPlan pl) {
  const int sgm = blockIdx.x * (MTT_BIN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (sgm >= pl.segments) return;
  int* row = pl.count + (long long)sgm * MTT_KEY_SEGMENT;
  int v[MTT_KEY_SEGMENT / 32];
#pragma unroll
  for (int j = 0; j < MTT_KEY_SEGMENT / 32; ++j) v[j] = row[j * 32 + lane];
  int carry = 0;
#pragma unroll
  for (int j = 0; j < MTT_KEY_SEGMENT / 32; ++j) {
    int inc = v[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    row[j * 32 + lane] = carry + inc - v[j];
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) pl.seg_start[sgm] = carry;
}

// Sort 3 (one block): the segments' totals to their first sorted slots, and
// the number of sorted points in seg_start[segments].
__global__ void __launch_bounds__(MTT_SCAN_THREADS)
grid_grad_scan_kernel(const __grid_constant__ MttGradPlan pl) {
  const int total = mtt_block_exclusive_scan(pl.seg_start, pl.segments);
  if (threadIdx.x == 0) pl.seg_start[pl.segments] = total;
}

// Sort 4: each sorted point's index to its slot: its segment's first slot,
// plus its cell's offset in the segment, plus its rank in the cell.
__global__ void __launch_bounds__(MTT_BIN_THREADS)
grid_grad_scatter_kernel(const __grid_constant__ MttInterpArgs a,
                         const __grid_constant__ MttGradPlan pl) {
  const long long base =
      (long long)blockIdx.x * (MTT_BIN_THREADS * MTT_BIN_PPT) + threadIdx.x;
  int key[MTT_BIN_PPT];
#pragma unroll
  for (int j = 0; j < MTT_BIN_PPT; ++j) {
    const long long p = base + (long long)j * MTT_BIN_THREADS;
    key[j] = p < a.n ? pl.key[p] : -1;
  }
  // All ranks first, then the stores: the atomics' latency overlaps.
  int slot[MTT_BIN_PPT];
#pragma unroll
  for (int j = 0; j < MTT_BIN_PPT; ++j) {
    slot[j] = key[j] < 0 ? -1
                         : pl.seg_start[key[j] / MTT_KEY_SEGMENT] + atomicAdd(&pl.count[key[j]], 1);
  }
#pragma unroll
  for (int j = 0; j < MTT_BIN_PPT; ++j) {
    if (slot[j] >= 0) pl.sorted[slot[j]] = (int)(base + (long long)j * MTT_BIN_THREADS);
  }
}

// Reduce: one thread per sorted point (the points' gradient is not taken
// here, where the sums hold many registers).  Lanes of a warp with equal keys (a
// run: the sort makes runs contiguous) sum their corner contributions by a
// segmented shuffle scan; the run's last lane sends them to the table.
__global__ void __launch_bounds__(MTT_RED_THREADS)
grid_grad_reduce_kernel(const __grid_constant__ MttInterpArgs a,
                        const __grid_constant__ MttGradPlan pl) {
  const long long q = (long long)blockIdx.x * MTT_RED_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = q < pl.seg_start[pl.segments];
  const long long p = live ? (long long)pl.sorted[q] : 0;
  MttAxes ax;
  unsigned valid = 0;
  int lin[8];
  float w[8];
  int key = -1 - lane;  // a lane past the end is a run of its own
  if (live) {
    mtt_point_axes(a, p, ax);
    valid = mtt_corners(ax, a.dims, lin, w);
    key = mtt_cell_key(ax, pl);
  }
  const int F = a.fdim;
  const float* gp = a.g + p * F;
  // The run of this lane: where it starts, and whether this lane ends it.
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const int next = __shfl_down_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
  const bool last = lane == 31 || next != key;
  for (int f = 0; f < F; f += 4) {
    float v[8][4];
    float gv[4];
    if (a.vec4 && live) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(gp + f));
      gv[0] = t.x;
      gv[1] = t.y;
      gv[2] = t.z;
      gv[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[e] = live && f + e < F ? __ldg(gp + f + e) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = w[c] * gv[e];
    }
    if (!live) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[c][e] = 0.f;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool take = lane - off >= start;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = __shfl_up_sync(0xffffffffu, v[c][e], off);
          if (take) v[c][e] += y;
        }
      }
    }
    if (!(live && last)) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!((valid >> c) & 1u)) continue;
      float* dst = a.out + (long long)lin[c] * F + f;
      if (a.vec4) {
        mtt_atomic_add4(dst, make_float4(v[c][0], v[c][1], v[c][2], v[c][3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (f + e < F) atomicAdd(dst + e, v[c][e]);
        }
      }
    }
  }
}

// The points' gradient of the sorted points, one thread each: in cell order
// the rows a warp reads are few and come from L1.
__global__ void __launch_bounds__(MTT_RED_THREADS)
grid_grad_points_kernel(const __grid_constant__ MttInterpArgs a,
                        const __grid_constant__ MttGradPlan pl) {
  const long long q = (long long)blockIdx.x * MTT_RED_THREADS + threadIdx.x;
  if (q >= pl.seg_start[pl.segments]) return;
  const long long p = pl.sorted[q];
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  int lin[8];
  float w[8];
  const unsigned valid = mtt_corners(ax, a.dims, lin, w);
  mtt_points_grad(a, ax, valid, lin, a.g + p * a.fdim, a.gx + 3 * p);
}

static int mtt_interp_check(const MttInterpArgs& a) {
  if (a.fdim < 1 || a.n < 0 || a.dims[0] < 1 || a.dims[1] < 1 || a.dims[2] < 1 ||
      (a.vec4 && a.fdim % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

static int mtt_grad_plan_check(const MttInterpArgs& a, const MttGradPlan& pl) {
  long long keys = 1;
  for (int k = 0; k < 3; ++k) {
    if (pl.cells[k] != a.dims[k] + 1) return (int)cudaErrorInvalidValue;
    keys *= pl.cells[k];
  }
  if ((long long)pl.segments * MTT_KEY_SEGMENT < keys ||
      (long long)(pl.segments - 1) * MTT_KEY_SEGMENT >= keys || a.n > 0x7fffffffLL ||
      pl.key == nullptr || pl.sorted == nullptr || pl.count == nullptr ||
      pl.seg_start == nullptr) {
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
  const long long per_block = MTT_BIN_THREADS * MTT_BIN_PPT;
  const unsigned bin_blocks = (unsigned)((a.n + per_block - 1) / per_block);
  const unsigned red_blocks = (unsigned)((a.n + MTT_RED_THREADS - 1) / MTT_RED_THREADS);
  const unsigned seg_blocks = (unsigned)((pl.segments + MTT_BIN_THREADS / 32 - 1) /
                                         (MTT_BIN_THREADS / 32));
  MTT_TRY(cudaMemsetAsync(pl.count, 0,
                          (size_t)pl.segments * MTT_KEY_SEGMENT * sizeof(int), s));
  grid_grad_bin_kernel<<<bin_blocks, MTT_BIN_THREADS, 0, s>>>(a, pl);
  MTT_TRY(cudaGetLastError());
  grid_grad_segscan_kernel<<<seg_blocks, MTT_BIN_THREADS, 0, s>>>(pl);
  MTT_TRY(cudaGetLastError());
  grid_grad_scan_kernel<<<1, MTT_SCAN_THREADS, 0, s>>>(pl);
  MTT_TRY(cudaGetLastError());
  grid_grad_scatter_kernel<<<bin_blocks, MTT_BIN_THREADS, 0, s>>>(a, pl);
  MTT_TRY(cudaGetLastError());
  grid_grad_reduce_kernel<<<red_blocks, MTT_RED_THREADS, 0, s>>>(a, pl);
  MTT_TRY(cudaGetLastError());
  if (a.gx != nullptr) {
    grid_grad_points_kernel<<<red_blocks, MTT_RED_THREADS, 0, s>>>(a, pl);
    MTT_TRY(cudaGetLastError());
  }
  return 0;
}

extern "C" {

// Zeroes the grid's gradient (a->out) and the counts, then sorts and reduces
// with the scratch of `plan`: two memsets and five kernels, and a sixth for
// the points' gradient.  With no points it
// only zeroes the gradient (a->g, a->gx and the scratch may then be null: an
// empty tensor has no storage).
int vc_grid_interp_backward(const MttInterpArgs* a, const MttGradPlan* plan, int device,
                             void* stream) {
  int bad = a->size != nullptr ? (int)cudaErrorInvalidValue : mtt_interp_check(*a);
  if (bad == 0 && a->n > 0) {
    bad = a->g == nullptr ? (int)cudaErrorInvalidValue : mtt_grad_plan_check(*a, *plan);
  }
  if (bad != 0) return bad;
  MTT_TRY(cudaSetDevice(device));
  const size_t table_bytes =
      (size_t)a->dims[0] * a->dims[1] * a->dims[2] * a->fdim * sizeof(float);
  MTT_TRY(cudaMemsetAsync(a->out, 0, table_bytes, (cudaStream_t)stream));
  if (a->n == 0) return 0;
  return mtt_grad_launch(*a, *plan, (cudaStream_t)stream);
}

}  // extern "C"
