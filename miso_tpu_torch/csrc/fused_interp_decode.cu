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
//   * per level: corner indices and weights exactly as
//     ops/interp.py::corner_indices_and_weights (zeros padding, optional
//     runtime logical size, strides from the static shape), F features per
//     corner gathered and lerped in registers, then scaled by 1 - ignore_level;
//   * the MLP's weights and biases are staged once per block in shared memory
//     (19 KB for 8 -> 64 -> 64 -> 1), output widths zero-padded to a multiple
//     of 16 (or of 4 below 16) so each k-step reads them as float4 broadcasts;
//   * hidden activations live in shared memory, one column per thread
//     ([unit][thread], bank-conflict free), ping-ponged between two buffers;
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
// maxima below; the Python wrapper (ops/fused_decode.py) validates them, lays
// out shared memory and mirrors these constants (checked by mtt_fused_limits).

#include <cuda_runtime.h>
#include <stdint.h>

#define MTT_MAX_LEVELS 8
#define MTT_MAX_LAYERS 8
#define MTT_MAX_WIDTH 128
#define MTT_THREADS 64

struct MttLevel {
  const float* grid;     // (dims[0], dims[1], dims[2], fdim), row-major
  const int32_t* size;   // (3,) logical size on the device, or null
  int dims[3];           // static storage shape (sets the strides)
};

struct MttFusedArgs {
  const float* x;        // (n, 3) world coordinates
  const float* bound;    // (3, 2) [lo, hi] per axis
  const float* ignore;   // (n_levels,) 1 = level ignored, or null
  float* out;            // (n, dims[n_layers])
  long long n;
  int n_levels;
  int fdim;
  int n_layers;
  int max_width;         // widest activation column, floats
  int w_floats;          // staged weights + biases, floats
  int smem_bytes;        // (w_floats + 2 * max_width * MTT_THREADS) * 4
  MttLevel levels[MTT_MAX_LEVELS];
  const float* W[MTT_MAX_LAYERS];   // (dims[l], dims[l + 1]) row-major
  const float* b[MTT_MAX_LAYERS];   // (dims[l + 1],)
  int dims[MTT_MAX_LAYERS + 1];
  int outp[MTT_MAX_LAYERS];         // padded output width of layer l
  int woff[MTT_MAX_LAYERS];         // shared-memory offset of W[l], floats
  int boff[MTT_MAX_LAYERS];         // shared-memory offset of b[l], floats
};

// One dense layer for this thread's point: CH outputs at a time in registers.
// Sums x @ W first and adds the bias after, the order of x @ W + b.
template <int CH>
__device__ __forceinline__ void dense_layer(const float* __restrict__ Ws,
                                            const float* __restrict__ bs,
                                            int in, int out, int outp, bool relu,
                                            const float* src, float* dst,
                                            float* gout, int tid) {
  for (int j0 = 0; j0 < out; j0 += CH) {
    float acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = 0.f;
    for (int k = 0; k < in; ++k) {
      const float h = src[k * MTT_THREADS + tid];
      const float4* w4 = reinterpret_cast<const float4*>(Ws + k * outp + j0);
#pragma unroll
      for (int q = 0; q < CH / 4; ++q) {
        const float4 w = w4[q];
        acc[4 * q + 0] = fmaf(h, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = j0 + c;
      if (j < out) {
        float v = acc[c] + bs[j];
        if (relu && v < 0.f) v = 0.f;  // keeps NaN, as torch.relu does
        if (dst != nullptr) {
          dst[j * MTT_THREADS + tid] = v;
        } else {
          gout[j] = v;
        }
      }
    }
  }
}

// __grid_constant__ lets the per-level and per-layer tables be indexed at run
// time straight from parameter space, without a per-thread local copy.
__global__ void __launch_bounds__(MTT_THREADS)
fused_interp_decode_kernel(const __grid_constant__ MttFusedArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;

  // Stage every layer's weights and biases, zero-padded to outp columns.
  for (int l = 0; l < a.n_layers; ++l) {
    const int in = a.dims[l], out = a.dims[l + 1], outp = a.outp[l];
    const float* W = a.W[l];
    float* Ws = smem + a.woff[l];
    for (int i = tid; i < in * outp; i += MTT_THREADS) {
      const int k = i / outp, j = i - k * outp;
      Ws[i] = j < out ? W[k * out + j] : 0.f;
    }
    float* bsm = smem + a.boff[l];
    for (int j = tid; j < outp; j += MTT_THREADS) {
      bsm[j] = j < out ? a.b[l][j] : 0.f;
    }
  }
  __syncthreads();
  float* act0 = smem + a.w_floats;
  float* act1 = act0 + a.max_width * MTT_THREADS;

  float lo[3], ext[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = a.bound[2 * k];
    ext[k] = a.bound[2 * k + 1] - lo[k];
  }
  const int F = a.fdim;

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
      int i0[3], nlog[3], hi_i[3];
      float fr[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int nk = lv.size != nullptr ? lv.size[k] : lv.dims[k];
        const float u = (xp[k] - lo[k]) / ext[k] * (float)nk - 0.5f;
        const float f0 = floorf(u);
        i0[k] = (int)f0;
        fr[k] = u - f0;
        nlog[k] = nk;
        // Clip to the logical size (as JAX does) and never past storage.
        hi_i[k] = min(nk, lv.dims[k]) - 1;
      }
      const int stride[3] = {lv.dims[1] * lv.dims[2], lv.dims[2], 1};
      int lin[8];
      float w[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // itertools.product order: axis 0 varies slowest.
        float wc = 1.f;
        bool ok = true;
        int li = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int bit = (c >> (2 - k)) & 1;
          const int ik = i0[k] + bit;
          ok = ok && ik >= 0 && ik < nlog[k];
          int ic = ik > hi_i[k] ? hi_i[k] : ik;
          ic = ic < 0 ? 0 : ic;
          li += ic * stride[k];
          wc *= bit ? fr[k] : 1.f - fr[k];
        }
        lin[c] = li;
        w[c] = ok ? wc : 0.f;
      }
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

    const float* src = act0;
    float* dst = act1;
    for (int l = 0; l < a.n_layers; ++l) {
      const bool last = l == a.n_layers - 1;
      float* gout = last ? a.out + p * a.dims[a.n_layers] : nullptr;
      float* d = last ? nullptr : dst;
      const float* Ws = smem + a.woff[l];
      const float* bs = smem + a.boff[l];
      if (a.outp[l] % 16 == 0) {
        dense_layer<16>(Ws, bs, a.dims[l], a.dims[l + 1], a.outp[l], !last,
                        src, d, gout, tid);
      } else {
        dense_layer<4>(Ws, bs, a.dims[l], a.dims[l + 1], a.outp[l], !last,
                       src, d, gout, tid);
      }
      float* t = const_cast<float*>(src);
      src = dst;
      dst = t;
    }
  }
}

extern "C" {

// The compile-time maxima, for the wrapper to check its mirror of them.
void mtt_fused_limits(int* out4) {
  out4[0] = MTT_MAX_LEVELS;
  out4[1] = MTT_MAX_LAYERS;
  out4[2] = MTT_MAX_WIDTH;
  out4[3] = MTT_THREADS;
}

const char* mtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` of CUDA device `device` and returns cudaGetLastError()
// of the launch (0 = ok).  Does not synchronise and allocates nothing.
int mtt_fused_interp_decode(const MttFusedArgs* args, int device, void* stream) {
  const MttFusedArgs& a = *args;
  if (a.n_levels < 1 || a.n_levels > MTT_MAX_LEVELS || a.n_layers < 1 ||
      a.n_layers > MTT_MAX_LAYERS || a.fdim < 1 ||
      a.n_levels * a.fdim != a.dims[0] || a.max_width > MTT_MAX_WIDTH) {
    return (int)cudaErrorInvalidValue;
  }
  int staged = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    if (a.dims[l + 1] < 1 || a.dims[l] > a.max_width || a.outp[l] < a.dims[l + 1] ||
        a.outp[l] % 4 != 0 || a.woff[l] != staged ||
        a.boff[l] != staged + a.dims[l] * a.outp[l]) {
      return (int)cudaErrorInvalidValue;
    }
    staged = a.boff[l] + a.outp[l];
  }
  if (staged != a.w_floats ||
      a.smem_bytes != (a.w_floats + 2 * a.max_width * MTT_THREADS) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n == 0) return 0;
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it from the caller's tensors.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fused_interp_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fused_interp_decode_kernel,
                                                    MTT_THREADS, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  const long long tiles = (a.n + MTT_THREADS - 1) / MTT_THREADS;
  const long long wave = (long long)sms * occ;
  const int blocks = (int)(tiles < wave ? tiles : wave);
  fused_interp_decode_kernel<<<blocks, MTT_THREADS, a.smem_bytes,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
