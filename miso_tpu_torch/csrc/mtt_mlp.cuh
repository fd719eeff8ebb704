// The ReLU MLP of one point per thread, shared by fused_interp_decode.cu (after
// the corner lerp) and mlp_decode.cu (the MLP alone), and the host-side launch
// both use.
//
// Layout: a block of MTT_THREADS threads stages every layer's weights and
// biases once in shared memory, each layer's output width zero-padded to
// outp[l] (a multiple of 16, or of 4 below 16) so a k-step reads them as
// float4 broadcasts; W[l] then b[l] back to back at woff[l], boff[l].  Two
// activation buffers of max_width floats per thread follow, one column per
// thread ([unit][thread], bank-conflict free), ping-ponged between layers.
// A null bias is a zero bias.  The Python wrapper computes the layout
// (ops/fused_decode.py::smem_layout) and mirrors the maxima below, which it
// checks against mtt_limits().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mtt_common.cuh"

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

extern "C" {

// The compile-time maxima, for the wrapper to check its mirror of them.
void mtt_limits(int* out4) {
  out4[0] = MTT_MAX_LEVELS;
  out4[1] = MTT_MAX_LAYERS;
  out4[2] = MTT_MAX_WIDTH;
  out4[3] = MTT_THREADS;
}

}  // extern "C"
