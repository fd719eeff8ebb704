// ReLU MLP decode, (N, F_in) -> (N, out): the MLP alone, on the tensor cores.
//
// Replaces the Pallas TPU kernel miso_tpu/ops/pallas_decode.py:107
// _decode_kernel (launched by _decode_T_impl through _decode_padded behind
// pallas_decode, the drop-in for ops/mlp.py::mlp_apply).  The TPU kernel ran
// transposed, points on the 128-wide lanes and inputs padded to 8 rows and 512
// points; that layout is the TPU's, not the function's.  Here the input stays
// (N, F_in) row-major, any N, and a null bias is a zero bias, as
// _pad_params_T makes it.
//
// What bounds it on an H100, at 8 -> 64 -> 64 -> 1: the operations.  Its
// 36 B per point of device memory take 0.011 ms per 1e6 points at 3.35 TB/s.
// In FP32 outside the tensor cores the MLP is 2 * (8*64 + 64*64 + 64*1) =
// 9.3 kflop per point, 0.14 ms per 1e6 points at 67 TFLOP/s; a
// one-thread-per-point design reached a quarter of that (0.556 ms per 1e6
// points, NVIDIA H100 80GB HBM3, 700 W), with a shared-memory load of weights
// per four FMAs and 8 resident warps per SM to hide it.
//
// Design (mtt_mma.cuh): the hidden layers go to the tensor cores in 3xTF32,
// mma.sync m16n8k8 with each operand split into a TF32 high and low part,
// three products for each FP32 one: widths padded to 8, 2 * (8*64 + 64*64) *
// 3 = 27.6 kflop per point, 0.056 ms per 1e6 points at the 495 TFLOP/s of
// the data sheet (wgmma's dense TF32 peak; mma.sync reaches about two thirds
// of it, scripts/mma_sync_peak.py).  The output layer of at most 4 columns is
// FP32 dot products on the CUDA cores (128 flop per point).  A block of 4
// warps stages the weights once in shared memory in the order the fragments
// read them; each warp walks tiles of 16 * MT points grid-stride, reads its
// input rows once from device memory into A fragments, keeps the activations
// in registers from layer to layer and writes its output rows once.  Shared
// memory is the weights alone (21,024 B at 8 -> 64 -> 64 -> 1, against
// 52,752 B per 64 threads before); registers are cut at 168 a thread for 3
// blocks, 12 warps, per SM.  A kernel is compiled for each NT (8-wide tiles
// of the widest layer: 1, 2, 4, 8, 16); up to NT = 8 a warp takes two 16-point
// tiles (MT = 2), so each B fragment read from shared memory feeds six mma.
// PERF.md has its times against the bound and the variants tried.

#include "mtt_mma.cuh"

struct MttDecodeArgs {
  const float* x;   // (n, mlp.dims[0]) row-major
  float* out;       // (n, mlp.dims[mlp.n_layers])
  long long n;
  MttMmaMlp mlp;
};

template <int NT, int MT>
__global__ void __launch_bounds__(MTT_MMA_THREADS, MTT_MMA_MIN_BLOCKS)
mlp_decode_kernel(const __grid_constant__ MttDecodeArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  mtt_mma_stage(a.mlp, smem, threadIdx.x, MTT_MMA_THREADS);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int in = a.mlp.dims[0];
  const int out = a.mlp.dims[a.mlp.n_layers];
  constexpr int ROWS = 16 * MT;
  for (long long base = ((long long)blockIdx.x * MTT_MMA_WARPS + warp) * ROWS; base < a.n;
       base += (long long)gridDim.x * MTT_MMA_WARPS * ROWS) {
    float act[MT][NT][4], acc[MT][NT][4];
    mtt_mma_load_rows<NT, MT>(a.x, in, a.n, base, lane, act);
    mtt_mma_run<NT, MT>(a.mlp, smem, lane, act, acc);
    mtt_mma_store_rows<NT, MT>(a.out, out, a.n, base, lane, acc);
  }
}

typedef void (*MttDecodeKernel)(const MttDecodeArgs);

// The kernel for the MLP's widest layer, and the points a warp takes per tile.
static MttDecodeKernel mtt_decode_kernel_for(const MttMmaMlp& m, int* rows_per_warp) {
  int widest = 0;
  for (int l = 0; l <= m.n_layers; ++l) widest = m.dims[l] > widest ? m.dims[l] : widest;
  const int t = mtt_mma_tiles(widest);
  *rows_per_warp = t <= 8 ? 32 : 16;
  if (t <= 1) return mlp_decode_kernel<1, 2>;
  if (t <= 2) return mlp_decode_kernel<2, 2>;
  if (t <= 4) return mlp_decode_kernel<4, 2>;
  if (t <= 8) return mlp_decode_kernel<8, 2>;
  return mlp_decode_kernel<16, 1>;
}

extern "C" {

// Launches on `stream` of CUDA device `device` and returns cudaGetLastError()
// of the launch (0 = ok).  Does not synchronise and allocates nothing.
int mtt_mlp_decode(const MttDecodeArgs* args, int device, void* stream) {
  const MttDecodeArgs& a = *args;
  const int bad = mtt_mma_check(a.mlp, a.mlp.dims[0]);
  if (bad != 0) return bad;
  int rows = 0;
  MttDecodeKernel kernel = mtt_decode_kernel_for(a.mlp, &rows);
  return mtt_mma_launch(kernel, a, a.n, rows, a.mlp.smem_bytes, device, stream);
}

// The kernel `args` selects: its resident blocks per SM, threads per block and
// points per warp tile, into out3.  Returns a CUDA error code (0 = ok).
int mtt_mlp_decode_occupancy(const MttDecodeArgs* args, int device, int* out3) {
  const MttDecodeArgs& a = *args;
  const int bad = mtt_mma_check(a.mlp, a.mlp.dims[0]);
  if (bad != 0) return bad;
  MttDecodeKernel kernel = mtt_decode_kernel_for(a.mlp, &out3[2]);
  out3[1] = MTT_MMA_THREADS;
  return (int)mtt_mma_occupancy(kernel, a.mlp.smem_bytes, device, &out3[0]);
}

}  // extern "C"
