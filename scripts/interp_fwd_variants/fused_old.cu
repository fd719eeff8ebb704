// The fused interp+decode kernel as the port first built it, kept to be
// measured against the shipped one (scripts/interp_fwd_variants.py): one
// thread per point, grid-stride over 64-point tiles with one resident wave of
// blocks; per level, corners and weights as mtt_grid.cuh computes them, F
// features gathered from the L2-resident tables and lerped in registers,
// scaled by 1 - ignore_level, into the thread's activation column; the MLP
// with weights and biases staged once per block in shared memory, each
// layer's output width zero-padded to outp[l] (a multiple of 16, or of 4
// below 16), W[l] then b[l] back to back at woff[l], boff[l], and two
// activation buffers of max_width floats per thread ([unit][thread]),
// ping-ponged between layers; FP32 on the CUDA cores.  Its host layout is
// scripts/interp_fwd_variants.py::old_fused_layout.  u is rounded as
// mtt_grid.cuh rounds it for every kernel now (op by op; the first version
// contracted it into an FMA).

#include "mtt_grid.cuh"

#define MTT_MAX_LEVELS 8
#define MTT_MAX_LAYERS 8
#define MTT_MAX_WIDTH 128
#define MTT_THREADS 64

struct MttMlp {
  int n_layers;
  int max_width;         // widest activation column, floats
  int w_floats;          // staged weights + biases, floats
  int smem_bytes;        // (w_floats + 2 * max_width * MTT_THREADS) * 4
  const float* W[MTT_MAX_LAYERS];   // (dims[l], dims[l + 1]) row-major
  const float* b[MTT_MAX_LAYERS];   // (dims[l + 1],), or null for zeros
  int dims[MTT_MAX_LAYERS + 1];
  int outp[MTT_MAX_LAYERS];         // padded output width of layer l
  int woff[MTT_MAX_LAYERS];         // shared-memory offset of W[l], floats
  int boff[MTT_MAX_LAYERS];         // shared-memory offset of b[l], floats
};

// Stage every layer's weights and biases, zero-padded to outp columns.  The
// caller synchronises the block after it.
__device__ __forceinline__ void mtt_stage_mlp(const MttMlp& m, float* smem, int tid) {
  for (int l = 0; l < m.n_layers; ++l) {
    const int in = m.dims[l], out = m.dims[l + 1], outp = m.outp[l];
    const float* W = m.W[l];
    float* Ws = smem + m.woff[l];
    for (int i = tid; i < in * outp; i += MTT_THREADS) {
      const int k = i / outp, j = i - k * outp;
      Ws[i] = j < out ? W[k * out + j] : 0.f;
    }
    const float* b = m.b[l];
    float* bsm = smem + m.boff[l];
    for (int j = tid; j < outp; j += MTT_THREADS) {
      bsm[j] = (j < out && b != nullptr) ? b[j] : 0.f;
    }
  }
}

// One dense layer for this thread's point: CH outputs at a time in registers.
// Sums x @ W first and adds the bias after, the order of x @ W + b.
template <int CH>
__device__ __forceinline__ void mtt_dense_layer(const float* __restrict__ Ws,
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

// The whole MLP for this thread's point: input in act0's column, output row
// (dims[n_layers] floats) written to gout.  act1 is the second buffer.
__device__ __forceinline__ void mtt_run_mlp(const MttMlp& m, const float* smem,
                                            float* act0, float* act1, float* gout,
                                            int tid) {
  const float* src = act0;
  float* dst = act1;
  for (int l = 0; l < m.n_layers; ++l) {
    const bool last = l == m.n_layers - 1;
    float* d = last ? nullptr : dst;
    float* g = last ? gout : nullptr;
    const float* Ws = smem + m.woff[l];
    const float* bs = smem + m.boff[l];
    if (m.outp[l] % 16 == 0) {
      mtt_dense_layer<16>(Ws, bs, m.dims[l], m.dims[l + 1], m.outp[l], !last, src, d,
                          g, tid);
    } else {
      mtt_dense_layer<4>(Ws, bs, m.dims[l], m.dims[l + 1], m.outp[l], !last, src, d,
                         g, tid);
    }
    float* t = const_cast<float*>(src);
    src = dst;
    dst = t;
  }
}

// Host: 0 when the layout is the one smem_layout computes for an input of
// in_dim floats, else cudaErrorInvalidValue.
static inline int mtt_mlp_check(const MttMlp& m, int in_dim) {
  if (m.n_layers < 1 || m.n_layers > MTT_MAX_LAYERS || m.dims[0] != in_dim ||
      m.max_width > MTT_MAX_WIDTH) {
    return (int)cudaErrorInvalidValue;
  }
  int staged = 0;
  for (int l = 0; l < m.n_layers; ++l) {
    if (m.dims[l + 1] < 1 || m.dims[l] > m.max_width || m.dims[l + 1] > m.max_width ||
        m.outp[l] < m.dims[l + 1] || m.outp[l] % 4 != 0 || m.woff[l] != staged ||
        m.boff[l] != staged + m.dims[l] * m.outp[l]) {
      return (int)cudaErrorInvalidValue;
    }
    staged = m.boff[l] + m.outp[l];
  }
  if (staged != m.w_floats ||
      m.smem_bytes != (m.w_floats + 2 * m.max_width * MTT_THREADS) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Host: launch `kernel` (MTT_THREADS threads, smem_bytes of dynamic shared
// memory) with one resident wave of blocks, or fewer when n is small, on
// `stream` of `device`; returns cudaGetLastError() of the launch.
template <typename Args>
static inline int mtt_launch_mlp_kernel(void (*kernel)(const Args), const Args& a,
                                        long long n, int smem_bytes, int device,
                                        void* stream) {
  if (n == 0) return 0;
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it from the caller's tensors.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, MTT_THREADS,
                                                    smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  const long long tiles = (n + MTT_THREADS - 1) / MTT_THREADS;
  const long long wave = (long long)sms * occ;
  const int blocks = (int)(tiles < wave ? tiles : wave);
  kernel<<<blocks, MTT_THREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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
old_fused_interp_decode_kernel(const __grid_constant__ MttFusedArgs a) {
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
int vf_old_fused_interp_decode(const MttFusedArgs* args, int device, void* stream) {
  const MttFusedArgs& a = *args;
  if (a.n_levels < 1 || a.n_levels > MTT_MAX_LEVELS || a.fdim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int bad = mtt_mlp_check(a.mlp, a.n_levels * a.fdim);
  if (bad != 0) return bad;
  return mtt_launch_mlp_kernel(old_fused_interp_decode_kernel, a, a.n, a.mlp.smem_bytes,
                               device, stream);
}

}  // extern "C"
