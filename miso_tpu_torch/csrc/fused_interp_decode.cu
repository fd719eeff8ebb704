// Fused multi-level trilinear interpolation + level concat + ReLU MLP decode.
//
// Replaces the Pallas TPU kernel miso_tpu/ops/pallas_decode.py::_fused_kernel
// (launched by _fused_impl behind fused_interp_decode).  It computes the whole
// function of fused_interp_decode, not the TPU block layout: the TPU kernel took
// pre-gathered corners because Mosaic cannot gather per point, so XLA built an
// (8*L*F, N) corner tensor in HBM.  Here each lane gathers its own point's
// corners, and neither the corner tensor, the (N, L*F) features nor any hidden
// activation reaches device memory.
//
// What bounds it on an H100: the MLP's operations.  At 8 -> 64 -> 64 -> 1 the
// hidden layers in 3xTF32 on the tensor cores are 27.6 kflop per point (0.056
// ms per 1e6 points at 495 TFLOP/s), against 16 B of device-memory traffic per
// point (x in, out back) and 8 * L gathered rows.
//
// Design: the decode kernel's MLP (mtt_mma.cuh: 3xTF32 mma.sync, activations
// in registers) fed by the lerp instead of by rows read from device memory.
//   * A block of 4 warps stages the weights once (mtt_mma_stage) and every
//     level whose table fits its shared-memory budget (mtt_stage_table; the
//     host decides, ops/tiled_interp.py::staged_tables): the coarse ScanNet
//     table, 42,336 B, beside 21,024 B of weights, leaves 3 blocks an SM.
//   * Each warp walks tiles of 16 * MT points grid-stride.  Lane i lerps point
//     i of the tile at every level (mtt_grid.cuh::mtt_lerp, from the staged
//     copy or from the L2-resident table), scales it by 1 - ignore_level[l]
//     and writes its L * F features to the warp's slice of shared memory,
//     one column per feature ([k][point], 16 * MT + 4 floats a column: the
//     writes of a warp and the fragment reads below are free of bank
//     conflicts); columns past L * F up to the next multiple of 8 hold zeros.
//   * The lanes read the slice back in A-fragment order (the layout
//     mtt_mma_load_rows produces from device memory), run every layer
//     (mtt_mma_run) and write their output rows once (mtt_mma_store_rows).
//
// Widths, level count, F and out_dim are run-time values up to the
// compile-time maxima of mtt_mma.cuh; the Python wrapper (ops/fused_decode.py)
// validates them, lays out shared memory (fused_layout) and mirrors the
// maxima (checked by mtt_limits); mtt_fused_check holds the layout to it.

#include "mtt_grid.cuh"
#include "mtt_mma.cuh"

struct MttLevel {
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  int dims[3];           // static storage shape (sets the strides)
  int staged;            // 1: copied to shared memory at soff
  int soff;              // floats from the start of shared memory
};

struct MttFusedArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* ignore;   // (n_levels,) 1 = level ignored, or null
  float* out;            // (n, mlp.dims[mlp.n_layers])
  long long n;
  int n_levels;
  int fdim;
  int vec4;              // rows as float4: fdim % 4 == 0, every table 16-byte aligned
  int rows_per_warp;     // 16 * MT of the kernel the widest layer selects
  int slice_off;         // floats: the 4 warps' feature slices, after the weights
  int smem_bytes;        // weights, slices and staged tables
  MttLevel levels[MTT_MAX_LEVELS];
  MttMmaMlp mlp;
};

// Writes one level's features into the warp's slice, scaled.
struct MttSliceSink {
  float* col;            // &slice[(l * F) * S + lane]
  int stride;            // S
  float scale;
  __device__ __forceinline__ void put(int f, float v) { col[f * stride] = v * scale; }
  __device__ __forceinline__ void put4(int f, float4 v) {
    col[f * stride] = v.x * scale;
    col[(f + 1) * stride] = v.y * scale;
    col[(f + 2) * stride] = v.z * scale;
    col[(f + 3) * stride] = v.w * scale;
  }
};

// __grid_constant__ lets the per-level and per-layer tables be indexed at run
// time straight from parameter space, without a per-thread local copy.
template <int NT, int MT>
__global__ void __launch_bounds__(MTT_MMA_THREADS, MTT_MMA_MIN_BLOCKS)
fused_interp_decode_kernel(const __grid_constant__ MttFusedArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  mtt_mma_stage(a.mlp, smem, tid, MTT_MMA_THREADS);
  const int F = a.fdim;
  for (int l = 0; l < a.n_levels; ++l) {
    const MttLevel& lv = a.levels[l];
    if (lv.staged) {
      mtt_stage_table(lv.grid, smem + lv.soff,
                      (long long)lv.dims[0] * lv.dims[1] * lv.dims[2] * F, tid,
                      MTT_MMA_THREADS);
    }
  }
  constexpr int ROWS = 16 * MT;
  constexpr int S = ROWS + 4;
  const int K = a.n_levels * F;
  const int k_tiles = mtt_mma_tiles(K);
  float* slice = smem + a.slice_off + warp * (8 * k_tiles * S);
  if (lane < ROWS) {
    for (int k = K; k < 8 * k_tiles; ++k) slice[k * S + lane] = 0.f;
  }
  __syncthreads();

  float lo[3], ext[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.bound[2 * k];
    ext[k] = a.bound[2 * k + 1] - lo[k];
  }
  const int out_dim = a.mlp.dims[a.mlp.n_layers];
  const bool vec4 = a.vec4 != 0;
  const int g = lane >> 2, c = 2 * (lane & 3);

  for (long long base = ((long long)blockIdx.x * MTT_MMA_WARPS + warp) * ROWS; base < a.n;
       base += (long long)gridDim.x * MTT_MMA_WARPS * ROWS) {
    const long long p = base + lane;
    if (lane < ROWS) {
      if (p < a.n) {
        float xp[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) xp[k] = __ldg(a.x + 3 * p + k);
        for (int l = 0; l < a.n_levels; ++l) {
          const MttLevel& lv = a.levels[l];
          MttAxes ax;
          mtt_axes(xp, lo, ext, lv.dims, lv.size, ax);
          int lin[8];
          float w[8];
          mtt_corners(ax, lv.dims, lin, w);
          MttSliceSink sink{slice + (l * F) * S + lane, S,
                            a.ignore != nullptr ? 1.f - __ldg(a.ignore + l) : 1.f};
          if (lv.staged) {
            mtt_lerp<true>(smem + lv.soff, lin, w, F, vec4, sink);
          } else {
            mtt_lerp<false>(lv.grid, lin, w, F, vec4, sink);
          }
        }
      } else {
        for (int k = 0; k < K; ++k) slice[k * S + lane] = 0.f;
      }
    }
    __syncwarp();
    // A fragments as mtt_mma_load_rows lays them out: lane (g, q) holds rows
    // g and g + 8 of each 16-row tile at k columns 8kt + 2q and 8kt + 2q + 1.
    float act[MT][NT][4], acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * mi + 8 * h + g;
#pragma unroll
        for (int kt = 0; kt < NT; ++kt) {
          if (kt < k_tiles) {
            act[mi][kt][h] = slice[(8 * kt + c) * S + row];
            act[mi][kt][2 + h] = slice[(8 * kt + c + 1) * S + row];
          }
        }
      }
    }
    __syncwarp();
    mtt_mma_run<NT, MT>(a.mlp, smem, lane, act, acc);
    mtt_mma_store_rows<NT, MT>(a.out, out_dim, a.n, base, lane, acc);
  }
}

typedef void (*MttFusedKernel)(const MttFusedArgs);

// Points a warp takes per tile for the MLP's widest layer (its input
// included), as the decode kernel chooses them.
static int mtt_fused_rows_per_warp(const MttMmaMlp& m) {
  int widest = 0;
  for (int l = 0; l <= m.n_layers; ++l) widest = m.dims[l] > widest ? m.dims[l] : widest;
  return mtt_mma_tiles(widest) <= 8 ? 32 : 16;
}

static MttFusedKernel mtt_fused_kernel_for(const MttMmaMlp& m) {
  int widest = 0;
  for (int l = 0; l <= m.n_layers; ++l) widest = m.dims[l] > widest ? m.dims[l] : widest;
  const int t = mtt_mma_tiles(widest);
  if (t <= 1) return fused_interp_decode_kernel<1, 2>;
  if (t <= 2) return fused_interp_decode_kernel<2, 2>;
  if (t <= 4) return fused_interp_decode_kernel<4, 2>;
  if (t <= 8) return fused_interp_decode_kernel<8, 2>;
  return fused_interp_decode_kernel<16, 1>;
}

// Host: 0 when the arguments are the layout ops/fused_decode.py::fused_layout
// computes, else cudaErrorInvalidValue.
static int mtt_fused_check(const MttFusedArgs& a) {
  if (a.n_levels < 1 || a.n_levels > MTT_MAX_LEVELS || a.fdim < 1 ||
      (a.vec4 && a.fdim % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bad = mtt_mma_check(a.mlp, a.n_levels * a.fdim);
  if (bad != 0) return bad;
  if (a.rows_per_warp != mtt_fused_rows_per_warp(a.mlp) || a.slice_off != a.mlp.w_floats) {
    return (int)cudaErrorInvalidValue;
  }
  long long off = a.slice_off + (long long)MTT_MMA_WARPS *
                                    (8 * mtt_mma_tiles(a.n_levels * a.fdim)) *
                                    (a.rows_per_warp + 4);
  for (int l = 0; l < a.n_levels; ++l) {
    const MttLevel& lv = a.levels[l];
    if (lv.dims[0] < 1 || lv.dims[1] < 1 || lv.dims[2] < 1) return (int)cudaErrorInvalidValue;
    if (!lv.staged) continue;
    if (lv.soff != off) return (int)cudaErrorInvalidValue;
    off += ((long long)lv.dims[0] * lv.dims[1] * lv.dims[2] * a.fdim + 3) / 4 * 4;
  }
  if (a.smem_bytes != off * 4) return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// Launches on `stream` of CUDA device `device` and returns cudaGetLastError()
// of the launch (0 = ok).  Does not synchronise and allocates nothing.
int mtt_fused_interp_decode(const MttFusedArgs* args, int device, void* stream) {
  const MttFusedArgs& a = *args;
  const int bad = mtt_fused_check(a);
  if (bad != 0) return bad;
  return mtt_mma_launch(mtt_fused_kernel_for(a.mlp), a, a.n, a.rows_per_warp, a.smem_bytes,
                        device, stream);
}

// The kernel `args` selects: its resident blocks per SM, threads per block and
// points per warp tile, into out3.  Returns a CUDA error code (0 = ok).
int mtt_fused_interp_decode_occupancy(const MttFusedArgs* args, int device, int* out3) {
  const MttFusedArgs& a = *args;
  const int bad = mtt_fused_check(a);
  if (bad != 0) return bad;
  out3[1] = MTT_MMA_THREADS;
  out3[2] = a.rows_per_warp;
  return (int)mtt_mma_occupancy(mtt_fused_kernel_for(a.mlp), a.smem_bytes, device, &out3[0]);
}

}  // extern "C"
