// Fused multi-level trilinear interpolation + level concat + ReLU MLP decode.
//
// Replaces the Pallas TPU kernel miso_tpu/ops/pallas_decode.py::_fused_kernel
// (launched by _fused_impl behind fused_interp_decode).  It computes the whole
// function of fused_interp_decode, not the TPU block layout: the TPU kernel took
// pre-gathered corners because Mosaic cannot gather per point, so XLA built an
// (8*L*F, N) corner tensor in HBM.  Here each thread gathers its own corners
// straight from the feature tables, which fit in the H100's 50 MB L2 (the fine
// ScanNet level is 104x88x31x4 f32, 4.5 MB), and neither the corner tensor nor
// any hidden activation reaches device memory.
//
// Design (simple and right first): one thread per point, grid-stride over
// 64-point tiles with one resident wave of blocks.
//   * per level: corner indices and weights as
//     ops/interp.py::corner_indices_and_weights (mtt_grid.cuh), F features per
//     corner gathered and lerped in registers, then scaled by 1 - ignore_level,
//     into the thread's activation column;
//   * the MLP as mtt_mlp.cuh runs it: weights and biases staged once per block
//     in shared memory (19 KB for 8 -> 64 -> 64 -> 1), hidden activations in
//     shared memory one column per thread;
//   * outputs (N, out_dim) are written once.
//
// What bounds it on an H100: the MLP, about 4.7 k FMAs per point on the FP32
// cores for 8 -> 64 -> 64 -> 1 (67 TFLOP/s peak: 0.14 ms per 1e6 points), against
// 16 B of device-memory traffic per point (x in, out back) and 16 * F gathered
// floats per point from L2.  Each k-step of a 16-wide output chunk issues five
// shared-memory loads for sixteen FMAs, so shared-memory issue, not the FMA
// pipes, is expected to cap it.  Warp-cooperative or mma-based MLP tiles and
// vectorised gathers are later work.
//
// Widths, level count, F and out_dim are run-time values up to the compile-time
// maxima of mtt_mlp.cuh; the Python wrapper (ops/fused_decode.py) validates
// them, lays out shared memory and mirrors the maxima (checked by mtt_limits).

#include "mtt_grid.cuh"
#include "mtt_mlp.cuh"

struct MttLevel {
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  int dims[3];           // static storage shape (sets the strides)
};

struct MttFusedArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* ignore;   // (n_levels,) 1 = level ignored, or null
  float* out;            // (n, mlp.dims[mlp.n_layers])
  long long n;
  int n_levels;
  int fdim;
  MttLevel levels[MTT_MAX_LEVELS];
  MttMlp mlp;
};

// __grid_constant__ lets the per-level and per-layer tables be indexed at run
// time straight from parameter space, without a per-thread local copy.
__global__ void __launch_bounds__(MTT_THREADS)
fused_interp_decode_kernel(const __grid_constant__ MttFusedArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  mtt_stage_mlp(a.mlp, smem, tid);
  __syncthreads();
  float* act0 = smem + a.mlp.w_floats;
  float* act1 = act0 + a.mlp.max_width * MTT_THREADS;

  float lo[3], ext[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.bound[2 * k];
    ext[k] = a.bound[2 * k + 1] - lo[k];
  }
  const int F = a.fdim;
  const int out_dim = a.mlp.dims[a.mlp.n_layers];

  // Each thread touches only its own activation column, so the tile loop
  // needs no block-level synchronisation.
  for (long long base = (long long)blockIdx.x * MTT_THREADS; base < a.n;
       base += (long long)gridDim.x * MTT_THREADS) {
    const long long p = base + tid;
    if (p >= a.n) continue;
    float xp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = a.x[3 * p + k];

    for (int l = 0; l < a.n_levels; ++l) {
      const MttLevel& lv = a.levels[l];
      MttAxes ax;
      mtt_axes(xp, lo, ext, lv.dims, lv.size, ax);
      int lin[8];
      float w[8];
      mtt_corners(ax, lv.dims, lin, w);
      const float* g = lv.grid;
      const float scale = a.ignore != nullptr ? 1.f - a.ignore[l] : 1.f;
      for (int f = 0; f < F; ++f) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc = fmaf(w[c], __ldg(g + (long long)lin[c] * F + f), acc);
        }
        act0[(l * F + f) * MTT_THREADS + tid] = acc * scale;
      }
    }
    mtt_run_mlp(a.mlp, smem, act0, act1, a.out + p * out_dim, tid);
  }
}

extern "C" {

// Launches on `stream` of CUDA device `device` and returns cudaGetLastError()
// of the launch (0 = ok).  Does not synchronise and allocates nothing.
int mtt_fused_interp_decode(const MttFusedArgs* args, int device, void* stream) {
  const MttFusedArgs& a = *args;
  if (a.n_levels < 1 || a.n_levels > MTT_MAX_LEVELS || a.fdim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int bad = mtt_mlp_check(a.mlp, a.n_levels * a.fdim);
  if (bad != 0) return bad;
  return mtt_launch_mlp_kernel(fused_interp_decode_kernel, a, a.n, a.mlp.smem_bytes,
                               device, stream);
}

}  // extern "C"
