// ReLU MLP decode, (N, F_in) -> (N, out): the MLP alone.
//
// Replaces the Pallas TPU kernel miso_tpu/ops/pallas_decode.py::_decode_kernel
// (launched by _decode_T_impl through _decode_padded behind pallas_decode, the
// drop-in for ops/mlp.py::mlp_apply).  The TPU kernel ran transposed, points on
// the 128-wide lanes and inputs padded to 8 rows and 512 points; that layout is
// the TPU's, not the function's.  Here the input stays (N, F_in) row-major, any
// N, and a null bias is a zero bias, as _pad_params_T makes it.
//
// Design: the MLP half of fused_interp_decode.cu, shared through mtt_mlp.cuh.
// One thread per point, grid-stride over 64-point tiles with one resident wave
// of blocks; weights and biases staged once per block in shared memory; the
// thread's input row read once into its activation column; hidden activations
// in shared memory; the output row written once.
//
// What bounds it on an H100: the FP32 FMAs, 2 * (8*64 + 64*64 + 64*1) = 9.3 k
// flops per point for 8 -> 64 -> 64 -> 1, 0.14 ms per 1e6 points at 67 TFLOP/s,
// against 36 B per point of device memory (0.011 ms at 3.35 TB/s).  As in the
// fused kernel, shared-memory issue (five loads per sixteen FMAs) is the
// expected cap; tensor-core tiles are later work.

#include "mtt_mlp.cuh"

struct MttDecodeArgs {
  const float* x;   // (n, mlp.dims[0]) row-major
  float* out;       // (n, mlp.dims[mlp.n_layers])
  long long n;
  MttMlp mlp;
};

__global__ void __launch_bounds__(MTT_THREADS)
mlp_decode_kernel(const __grid_constant__ MttDecodeArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  mtt_stage_mlp(a.mlp, smem, tid);
  __syncthreads();
  float* act0 = smem + a.mlp.w_floats;
  float* act1 = act0 + a.mlp.max_width * MTT_THREADS;
  const int in = a.mlp.dims[0];
  const int out_dim = a.mlp.dims[a.mlp.n_layers];

  for (long long base = (long long)blockIdx.x * MTT_THREADS; base < a.n;
       base += (long long)gridDim.x * MTT_THREADS) {
    const long long p = base + tid;
    if (p >= a.n) continue;
    const float* xr = a.x + p * in;
    for (int k = 0; k < in; ++k) act0[k * MTT_THREADS + tid] = __ldg(xr + k);
    mtt_run_mlp(a.mlp, smem, act0, act1, a.out + p * out_dim, tid);
  }
}

extern "C" {

// Launches on `stream` of CUDA device `device` and returns cudaGetLastError()
// of the launch (0 = ok).  Does not synchronise and allocates nothing.
int mtt_mlp_decode(const MttDecodeArgs* args, int device, void* stream) {
  const MttDecodeArgs& a = *args;
  const int bad = mtt_mlp_check(a.mlp, a.mlp.dims[0]);
  if (bad != 0) return bad;
  if (a.mlp.dims[0] < 1) return (int)cudaErrorInvalidValue;
  return mtt_launch_mlp_kernel(mlp_decode_kernel, a, a.n, a.mlp.smem_bytes, device,
                               stream);
}

}  // extern "C"
