// The interp grad kernel in the shape of the TPU kernel it replaces
// (miso_tpu/ops/pallas_interp.py:268 _interp_grad_kernel), for the H100:
// points binned by tile, each tile's gradient summed in shared memory, one
// flush per row.  Built and timed against the shipped kernel
// (miso_tpu_torch/csrc/grid_interp.cu) by scripts/interp_grad_variants.py;
// not shipped (PERF.md, Findings).
//
// n points, table (X, Y, Z, F), no logical size (size = None):
//   1. bin:        each point's tile from its floor cell (floor cells -1 ..
//                  dims - 1 per axis, tiles of T cells); -1, and a zero
//                  points' gradient, when none of its corners is valid;
//                  per-block histograms in shared memory added to the
//                  tiles' counts;
//   2. scan:       one block: counts to each tile's first sorted slot, and
//                  work items per tile (ceil(count / P)) to each tile's first
//                  work item;
//   3. scatter:    ranks in a shared-memory histogram, one global atomic per
//                  tile and block to reserve a run, int32 point indices in
//                  tile order;
//   4. accumulate: one block per work item (a tile and at most P of its
//                  points): zero the tile's (T + 1)^3 rows in shared memory
//                  (and stage its table rows when the points' gradient is
//                  asked), add w_c * g with shared-memory atomics, then flush
//                  each row that is not zero with one global float4 atomic
//                  (scalar ones when not vec4).
// A table whose rows fit the shared-memory budget is one tile: steps 1-3 are
// skipped and the work items are slices of the points in the caller's order.

#include "mtt_grid.cuh"

#define VT_THREADS 256
#define VT_PPT 8             // points per thread in the bin and scatter kernels
#define VT_SCAN_THREADS 1024
#define VT_SHARED_HIST 4096  // tiles counted in shared memory (else globally)

struct MttInterpArgs {  // as in miso_tpu_torch/csrc/grid_interp.cu
  const float* x;
  const float* bound;
  const float* grid;
  const int32_t* size;
  const float* g;
  float* out;
  float* gx;
  long long n;
  int dims[3];
  int fdim;
  int vec4;
};

struct VtPlan {
  int tile[3];       // cells per tile per axis (single: dims)
  int tiles[3];      // tiles per axis: ceil((dims + 1) / tile)
  int halo[3];       // rows per axis of a tile with its halo: tile + 1 (single: dims)
  int single;        // 1: the table is one tile, no sort
  int per_item;      // points per work item
  int n_tiles;
  int32_t* key;      // (n,) each point's tile, -1 when it has no valid corner
  int32_t* offset;   // (n_tiles + 1,) counts, then first sorted slot; [n_tiles]: total
  int32_t* cursor;   // (n_tiles,) next free slot while scattering
  int32_t* item;     // (n_tiles + 1,) first work item of each tile; [n_tiles]: total
  int32_t* sorted;   // (n,) point indices in tile order
};

__device__ __forceinline__ void vt_point_axes(const MttInterpArgs& a, long long p,
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

__device__ __forceinline__ bool vt_any_corner_valid(const MttAxes& ax) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i0 = ax.i0[k], n = ax.n[k];
    ok = ok && ((i0 >= 0 && i0 < n) || (i0 >= -1 && i0 < n - 1));
  }
  return ok;
}

__device__ __forceinline__ int vt_tile_key(const MttAxes& ax, const VtPlan& pl) {
  int t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = (ax.i0[k] + 1) / pl.tile[k];
  return (t[0] * pl.tiles[1] + t[1]) * pl.tiles[2] + t[2];
}

__device__ __forceinline__ void vt_atomic_add4(float* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst + 0, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// Exclusive prefix sum of v[0, len) in place by one whole block; returns the
// total to every thread.
__device__ int vt_block_exclusive_scan(int* v, int len) {
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

__global__ void __launch_bounds__(VT_THREADS)
vt_bin_kernel(const __grid_constant__ MttInterpArgs a, const __grid_constant__ VtPlan pl) {
  __shared__ int hist[VT_SHARED_HIST];
  const bool local = pl.n_tiles <= VT_SHARED_HIST;
  if (local) {
    for (int i = threadIdx.x; i < pl.n_tiles; i += VT_THREADS) hist[i] = 0;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * (VT_THREADS * VT_PPT) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < VT_PPT; ++j) {
    const long long p = base + (long long)j * VT_THREADS;
    if (p >= a.n) continue;
    MttAxes ax;
    vt_point_axes(a, p, ax);
    int key = -1;
    if (vt_any_corner_valid(ax)) {
      key = vt_tile_key(ax, pl);
      if (local) {
        atomicAdd(&hist[key], 1);
      } else {
        atomicAdd(&pl.offset[key], 1);
      }
    } else if (a.gx != nullptr) {
      a.gx[3 * p] = 0.f;
      a.gx[3 * p + 1] = 0.f;
      a.gx[3 * p + 2] = 0.f;
    }
    pl.key[p] = key;
  }
  __syncthreads();
  if (local) {
    for (int i = threadIdx.x; i < pl.n_tiles; i += VT_THREADS) {
      if (hist[i] != 0) atomicAdd(&pl.offset[i], hist[i]);
    }
  }
}

__global__ void __launch_bounds__(VT_SCAN_THREADS)
vt_scan_kernel(const __grid_constant__ VtPlan pl) {
  for (int t = threadIdx.x; t < pl.n_tiles; t += VT_SCAN_THREADS) {
    pl.item[t] = (pl.offset[t] + pl.per_item - 1) / pl.per_item;
  }
  __syncthreads();
  const int total = vt_block_exclusive_scan(pl.offset, pl.n_tiles);
  const int items = vt_block_exclusive_scan(pl.item, pl.n_tiles);
  for (int t = threadIdx.x; t < pl.n_tiles; t += VT_SCAN_THREADS) pl.cursor[t] = pl.offset[t];
  if (threadIdx.x == 0) {
    pl.offset[pl.n_tiles] = total;
    pl.item[pl.n_tiles] = items;
  }
}

__global__ void __launch_bounds__(VT_THREADS)
vt_scatter_kernel(const __grid_constant__ MttInterpArgs a, const __grid_constant__ VtPlan pl) {
  __shared__ int cnt[VT_SHARED_HIST];  // the block's counts, then its runs' first slots
  const bool local = pl.n_tiles <= VT_SHARED_HIST;
  if (local) {
    for (int i = threadIdx.x; i < pl.n_tiles; i += VT_THREADS) cnt[i] = 0;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * (VT_THREADS * VT_PPT) + threadIdx.x;
  int key[VT_PPT], rank[VT_PPT];
#pragma unroll
  for (int j = 0; j < VT_PPT; ++j) {
    const long long p = base + (long long)j * VT_THREADS;
    key[j] = p < a.n ? pl.key[p] : -1;
    if (key[j] < 0) {
      rank[j] = -1;
    } else if (local) {
      rank[j] = atomicAdd(&cnt[key[j]], 1);
    } else {
      rank[j] = atomicAdd(&pl.cursor[key[j]], 1);
    }
  }
  __syncthreads();
  if (local) {
    for (int i = threadIdx.x; i < pl.n_tiles; i += VT_THREADS) {
      const int c = cnt[i];
      if (c != 0) cnt[i] = atomicAdd(&pl.cursor[i], c);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VT_PPT; ++j) {
    if (key[j] < 0) continue;
    pl.sorted[(local ? cnt[key[j]] : 0) + rank[j]] = (int)(base + (long long)j * VT_THREADS);
  }
}

__global__ void __launch_bounds__(VT_THREADS)
vt_accumulate_kernel(const __grid_constant__ MttInterpArgs a, const __grid_constant__ VtPlan pl) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int F = a.fdim;
  const int rows = pl.halo[0] * pl.halo[1] * pl.halo[2];
  float* stage = acc + rows * F;
  const int b = blockIdx.x;
  long long first, last;
  int org[3] = {0, 0, 0};
  if (pl.single) {
    first = (long long)b * pl.per_item;
    if (first >= a.n) return;
    last = min(a.n, first + pl.per_item);
  } else {
    if (b >= pl.item[pl.n_tiles]) return;
    int lo = 0, hi = pl.n_tiles - 1;  // the last tile whose first item is <= b
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (pl.item[mid] <= b) lo = mid; else hi = mid - 1;
    }
    const int t = lo;
    first = pl.offset[t] + (long long)(b - pl.item[t]) * pl.per_item;
    last = min((long long)pl.offset[t + 1], first + pl.per_item);
    const int tc[3] = {t / (pl.tiles[1] * pl.tiles[2]), (t / pl.tiles[2]) % pl.tiles[1],
                       t % pl.tiles[2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) org[k] = tc[k] * pl.tile[k] - 1;
  }
  // Zero the accumulator; stage the tile's rows for the points' gradient.
  for (int i = threadIdx.x; i < rows * F; i += VT_THREADS) acc[i] = 0.f;
  if (a.gx != nullptr) {
    for (int r = threadIdx.x; r < rows; r += VT_THREADS) {
      const int l[3] = {r / (pl.halo[1] * pl.halo[2]), (r / pl.halo[2]) % pl.halo[1],
                        r % pl.halo[2]};
      bool in = true;
      long long grow = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = org[k] + l[k];
        in = in && i >= 0 && i < a.dims[k];
        grow = grow * a.dims[k] + i;
      }
      for (int f = 0; f < F; ++f) stage[r * F + f] = in ? __ldg(a.grid + grow * F + f) : 0.f;
    }
  }
  __syncthreads();
  for (long long q = first + threadIdx.x; q < last; q += VT_THREADS) {
    const long long p = pl.single ? q : (long long)pl.sorted[q];
    MttAxes ax;
    vt_point_axes(a, p, ax);
    int lin[8], lr[8];
    float w[8];
    const unsigned valid = mtt_corners(ax, a.dims, lin, w);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int l = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) l = l * pl.halo[k] + ax.i0[k] + ((c >> (2 - k)) & 1) - org[k];
      lr[c] = l;
    }
    const float* gp = a.g + p * F;
    float dot[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) dot[c] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float gf = __ldg(gp + f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (!((valid >> c) & 1u)) continue;
        atomicAdd(acc + lr[c] * F + f, w[c] * gf);
        if (a.gx != nullptr) dot[c] = fmaf(gf, stage[lr[c] * F + f], dot[c]);
      }
    }
    if (a.gx != nullptr) {
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
  }
  __syncthreads();
  // Flush: each row that is not zero, once.
  for (int r = threadIdx.x; r < rows; r += VT_THREADS) {
    const int l[3] = {r / (pl.halo[1] * pl.halo[2]), (r / pl.halo[2]) % pl.halo[1],
                      r % pl.halo[2]};
    bool in = true;
    long long grow = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = org[k] + l[k];
      in = in && i >= 0 && i < a.dims[k];
      grow = grow * a.dims[k] + i;
    }
    if (!in) continue;
    const float* src = acc + r * F;
    float* dst = a.out + grow * F;
    if (a.vec4) {
      for (int f = 0; f < F; f += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + f);
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) vt_atomic_add4(dst + f, v);
      }
    } else {
      for (int f = 0; f < F; ++f) {
        if (src[f] != 0.f) atomicAdd(dst + f, src[f]);
      }
    }
  }
}

#define VT_TRY(expr)                            \
  do {                                          \
    const cudaError_t vt_e = (expr);            \
    if (vt_e != cudaSuccess) return (int)vt_e;  \
  } while (0)

extern "C" {

// Zeroes the gradient (and the counts), then bins, scans, scatters and
// accumulates on `stream`; `items` is the accumulate kernel's grid (at least
// the work items: ceil(n / per_item) + n_tiles), `smem_bytes` its dynamic
// shared memory.  Returns the first CUDA error (0 = ok).
int vt_grid_interp_backward(const MttInterpArgs* a, const VtPlan* pl, int items,
                            int smem_bytes, int device, void* stream) {
  if (a->size != nullptr || a->fdim < 1 || (a->vec4 && a->fdim % 4 != 0) || a->n < 0 ||
      a->n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  VT_TRY(cudaSetDevice(device));
  const size_t table_bytes =
      (size_t)a->dims[0] * a->dims[1] * a->dims[2] * a->fdim * sizeof(float);
  VT_TRY(cudaMemsetAsync(a->out, 0, table_bytes, s));
  if (a->n == 0) return 0;
  VT_TRY(cudaFuncSetAttribute(vt_accumulate_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (!pl->single) {
    VT_TRY(cudaMemsetAsync(pl->offset, 0, (size_t)(pl->n_tiles + 1) * sizeof(int), s));
    const long long per_block = VT_THREADS * VT_PPT;
    const unsigned blocks = (unsigned)((a->n + per_block - 1) / per_block);
    vt_bin_kernel<<<blocks, VT_THREADS, 0, s>>>(*a, *pl);
    VT_TRY(cudaGetLastError());
    vt_scan_kernel<<<1, VT_SCAN_THREADS, 0, s>>>(*pl);
    VT_TRY(cudaGetLastError());
    vt_scatter_kernel<<<blocks, VT_THREADS, 0, s>>>(*a, *pl);
    VT_TRY(cudaGetLastError());
  }
  vt_accumulate_kernel<<<(unsigned)items, VT_THREADS, smem_bytes, s>>>(*a, *pl);
  return (int)cudaGetLastError();
}

}  // extern "C"
