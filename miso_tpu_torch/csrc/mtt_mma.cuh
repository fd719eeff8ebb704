// The ReLU MLP on the tensor cores: a warp runs a tile of 16 * MT points
// through every layer with mma.sync m16n8k8 in 3xTF32, activations kept in
// registers from layer to layer; an output layer of at most 4 columns is FP32
// dot products on the CUDA cores instead.  Used by mlp_decode.cu, which reads
// its input rows with mtt_mma_load_rows, and by fused_interp_decode.cu, which
// fills the first layer's A fragments with its lerped features instead.
//
// Numerics.  Each operand v is split into two TF32 parts, hi = rna(v) and
// lo = v - hi cut to TF32, and a product is lo*hi + hi*lo + hi*hi summed in
// FP32 by the tensor core: lo*lo and the bits cut from lo (each under 2^-21
// of the product) are all that is left out, so the result agrees with an FP32
// product to a few FP32 ulp.  Bias add, ReLU (NaN kept, as torch.relu keeps
// it) and the output stay in FP32.
//
// Fragments.  In m16n8k8 a lane (g = lane / 4, q = lane % 4) holds A at rows
// {g, g + 8} and k-columns {q, q + 4}, B at k-rows {q, q + 4} and column g, and
// the accumulator at rows {g, g + 8} and columns {2q, 2q + 1}.  The k index of
// every layer is taken in the order p = q <-> unit 2q, p = q + 4 <-> unit
// 2q + 1 of its 8-wide tile, in A and in B alike, which leaves the product
// unchanged; then a layer's accumulator, after bias and ReLU, is the next
// layer's A fragment as it stands: a0 = c0, a1 = c2, a2 = c1, a3 = c3.
//
// Shared memory.  Each layer's weights, zero-padded to multiples of 8 in both
// dimensions, are staged in FP32 in the order the lanes read them: float2
// ((kt * n_tiles + nt) * 32 + lane) holds W[8kt + 2q][8nt + g] and
// W[8kt + 2q + 1][8nt + g], the lane's b0 and b1, so a warp's read is 256
// contiguous bytes.  Its bias follows, zero-padded to a multiple of 8.  The
// split into hi and lo is done as the fragments are read, which keeps the
// staged weights at one float each.  The Python wrapper computes the offsets
// (ops/fused_decode.py::mma_layout); mtt_mma_check holds them to it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mtt_common.cuh"

// The compile-time maxima; the Python wrapper mirrors them and checks its
// mirror against mtt_limits().
#define MTT_MAX_LEVELS 8
#define MTT_MAX_LAYERS 8
#define MTT_MAX_WIDTH 128

#define MTT_MMA_THREADS 128
#define MTT_MMA_WARPS (MTT_MMA_THREADS / 32)
// Blocks per SM the register budget is cut for: 65,536 / (128 * 3) leaves a
// thread 168 registers for the 128 floats of activations and sums of the
// widest tiles (NT * MT = 16); more registers and 2 blocks ran slower.
#define MTT_MMA_MIN_BLOCKS 3

struct MttMmaMlp {
  int n_layers;
  int w_floats;     // staged weights + biases, floats
  int smem_bytes;   // w_floats * 4
  const float* W[MTT_MAX_LAYERS];   // (dims[l], dims[l + 1]) row-major
  const float* b[MTT_MAX_LAYERS];   // (dims[l + 1],), or null for zeros
  int dims[MTT_MAX_LAYERS + 1];
  int woff[MTT_MAX_LAYERS];         // shared-memory offset of layer l's weights, floats
  int boff[MTT_MAX_LAYERS];         // shared-memory offset of its bias, floats
};

// 8-wide tiles of a width.
__host__ __device__ __forceinline__ int mtt_mma_tiles(int width) { return (width + 7) >> 3; }

// v = hi + lo in TF32: hi is v rounded to nearest TF32, ties away from zero
// (what cvt.rna.tf32.f32 gives, in two integer operations where cvt takes
// five); lo is v - hi, exact in FP32, cut to TF32 by dropping its low 13 bits.
// A NaN v gives a NaN lo, so NaN propagates through the lo products.
__device__ __forceinline__ void mtt_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// max(v, 0) as one integer max on the bits: a negative float is a negative
// int.  Keeps NaN: the device's arithmetic gives the NaN 0x7fffffff, positive
// as an int, as torch.relu keeps NaN.
__device__ __forceinline__ float mtt_relu(float v) {
  return __int_as_float(max(__float_as_int(v), 0));
}

// d += A * B for one m16n8k8 TF32 tile, FP32 sums.
__device__ __forceinline__ void mtt_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage every layer's weights and biases (layout above).  The caller
// synchronises the block after it.
__device__ __forceinline__ void mtt_mma_stage(const MttMmaMlp& m, float* smem, int tid,
                                              int nthreads) {
  for (int l = 0; l < m.n_layers; ++l) {
    const int in = m.dims[l], out = m.dims[l + 1];
    const int n_tiles = mtt_mma_tiles(out);
    const int count = mtt_mma_tiles(in) * n_tiles * 64;
    const float* W = m.W[l];
    float* ws = smem + m.woff[l];
#pragma unroll 4
    for (int i = tid; i < count; i += nthreads) {
      const int tile = i >> 6, lane = (i >> 1) & 31;
      const int kt = tile / n_tiles, nt = tile - kt * n_tiles;
      const int k = 8 * kt + 2 * (lane & 3) + (i & 1), n = 8 * nt + (lane >> 2);
      ws[i] = (k < in && n < out) ? W[k * out + n] : 0.f;
    }
    const float* b = m.b[l];
    float* bs = smem + m.boff[l];
    for (int j = tid; j < 8 * n_tiles; j += nthreads) {
      bs[j] = (j < out && b != nullptr) ? b[j] : 0.f;
    }
  }
}

// The first layer's A fragments from rows [base, base + 16 * MT) of a
// row-major (n, in) array; rows past n and columns past in read as zeros.
template <int NT, int MT>
__device__ __forceinline__ void mtt_mma_load_rows(const float* __restrict__ x, int in,
                                                  long long n, long long base, int lane,
                                                  float (&act)[MT][NT][4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int k_tiles = mtt_mma_tiles(in);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8: a0, a2 and a1, a3
      const long long row = base + 16 * mi + 8 * h + g;
      const bool ok = row < n;
      const float* xr = x + row * in;
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        if (kt < k_tiles) {
          const int k = 8 * kt + c;
          act[mi][kt][h] = (ok && k < in) ? __ldg(xr + k) : 0.f;
          act[mi][kt][2 + h] = (ok && k + 1 < in) ? __ldg(xr + k + 1) : 0.f;
        }
      }
    }
  }
}

// One layer's products for the warp's tile: acc = act @ W, act holding k_tiles
// A fragments and acc n_tiles accumulator fragments.  FULL: n_tiles == NT,
// so the inner loop runs without a guard and with constant offsets.
template <int NT, int MT, bool FULL>
__device__ __forceinline__ void mtt_mma_layer(const float2* __restrict__ ws, int k_tiles,
                                              int n_tiles, const float (&act)[MT][NT][4],
                                              float (&acc)[MT][NT][4]) {
  const int stride = FULL ? NT : n_tiles;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nt][r] = 0.f;
    }
  }
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < k_tiles) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) mtt_split(act[mi][kt][r], ahi[mi][r], alo[mi][r]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (FULL || nt < n_tiles) {
          const float2 w = ws[(kt * stride + nt) * 32];
          uint32_t bhi0, blo0, bhi1, blo1;
          mtt_split(w.x, bhi0, blo0);
          mtt_split(w.y, bhi1, blo1);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mtt_mma(acc[mi][nt], alo[mi], bhi0, bhi1);
            mtt_mma(acc[mi][nt], ahi[mi], blo0, blo1);
            mtt_mma(acc[mi][nt], ahi[mi], bhi0, bhi1);
          }
        }
      }
    }
  }
}

// An output layer of at most 4 columns, in FP32 on the CUDA cores: on the
// tensor cores its one n tile would chain every k tile's three mma on one
// accumulator and split every activation for a sixth of the work.  Lane
// (g, q) sums its columns 8kt + 2q, 2q + 1 of each row against the weights
// of column j (the float2 that lane (j, q) reads in mtt_mma_layer), the quad
// adds its four lanes' sums, and lane q keeps columns 2q, 2q + 1 in acc[.][0],
// where mtt_mma_store_rows finds them.
template <int NT, int MT>
__device__ __forceinline__ void mtt_dot_layer(const float2* __restrict__ ws, int k_tiles,
                                              int out, int lane,
                                              const float (&act)[MT][NT][4],
                                              float (&acc)[MT][NT][4]) {
  const int q = lane & 3;
  float part[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[mi][h][j] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < k_tiles) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < out) {
          const float2 w = ws[kt * 32 + 4 * j + q];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              part[mi][h][j] = fmaf(act[mi][kt][2 + h], w.y,
                                    fmaf(act[mi][kt][h], w.x, part[mi][h][j]));
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < out) {
          part[mi][h][j] += __shfl_xor_sync(0xffffffffu, part[mi][h][j], 1);
          part[mi][h][j] += __shfl_xor_sync(0xffffffffu, part[mi][h][j], 2);
        }
      }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[mi][0][2 * h] = q == 0 ? part[mi][h][0] : part[mi][h][2];
      acc[mi][0][2 * h + 1] = q == 0 ? part[mi][h][1] : part[mi][h][3];
    }
}

// Every layer of the MLP for the warp's tile: act holds the first layer's A
// fragments (NT >= the tiles of every width), and on return acc holds the
// last layer's output, bias added, as accumulator fragments.  The last layer
// goes to mtt_dot_layer when it has at most 4 columns.
template <int NT, int MT>
__device__ __forceinline__ void mtt_mma_run(const MttMmaMlp& m, const float* smem, int lane,
                                            float (&act)[MT][NT][4], float (&acc)[MT][NT][4]) {
  const int c = 2 * (lane & 3);
  for (int l = 0; l < m.n_layers; ++l) {
    const int k_tiles = mtt_mma_tiles(m.dims[l]), n_tiles = mtt_mma_tiles(m.dims[l + 1]);
    const float2* ws = reinterpret_cast<const float2*>(smem + m.woff[l]) + lane;
    if (l + 1 == m.n_layers && m.dims[l + 1] <= 4) {
      mtt_dot_layer<NT, MT>(reinterpret_cast<const float2*>(smem + m.woff[l]), k_tiles,
                            m.dims[l + 1], lane, act, acc);
    } else if (n_tiles == NT) {
      mtt_mma_layer<NT, MT, true>(ws, k_tiles, n_tiles, act, acc);
    } else {
      mtt_mma_layer<NT, MT, false>(ws, k_tiles, n_tiles, act, acc);
    }
    // Sums first, bias after: the order of x @ W + b.
    const float* bs = smem + m.boff[l];
    const bool hidden = l + 1 < m.n_layers;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < n_tiles) {
        const float2 bias = *reinterpret_cast<const float2*>(bs + 8 * nt + c);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float(&d)[4] = acc[mi][nt];
          d[0] += bias.x;
          d[1] += bias.y;
          d[2] += bias.x;
          d[3] += bias.y;
          if (hidden) {  // ReLU; the accumulator is the next A fragment
            act[mi][nt][0] = mtt_relu(d[0]);
            act[mi][nt][1] = mtt_relu(d[2]);
            act[mi][nt][2] = mtt_relu(d[1]);
            act[mi][nt][3] = mtt_relu(d[3]);
          }
        }
      }
    }
  }
}

// Write the last layer's accumulator fragments to rows [base, base + 16 * MT)
// of a row-major (n, width) array, rows past n and columns past width left out.
template <int NT, int MT>
__device__ __forceinline__ void mtt_mma_store_rows(float* __restrict__ out, int width,
                                                   long long n, long long base, int lane,
                                                   const float (&acc)[MT][NT][4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int n_tiles = mtt_mma_tiles(width);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g (c0, c1) and g + 8 (c2, c3)
      const long long row = base + 16 * mi + 8 * h + g;
      if (row >= n) continue;
      float* orow = out + row * width;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < n_tiles) {
          const int k = 8 * nt + c;
          if (k < width) orow[k] = acc[mi][nt][2 * h];
          if (k + 1 < width) orow[k + 1] = acc[mi][nt][2 * h + 1];
        }
      }
    }
  }
}

// Host: 0 when the layout is the one mma_layout computes for an input of
// in_dim floats, else cudaErrorInvalidValue.
static inline int mtt_mma_check(const MttMmaMlp& m, int in_dim) {
  if (m.n_layers < 1 || m.n_layers > MTT_MAX_LAYERS || m.dims[0] != in_dim) {
    return (int)cudaErrorInvalidValue;
  }
  int staged = 0;
  for (int l = 0; l <= m.n_layers; ++l) {
    if (m.dims[l] < 1 || m.dims[l] > MTT_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < m.n_layers; ++l) {
    const int n_tiles = mtt_mma_tiles(m.dims[l + 1]);
    if (m.woff[l] != staged) return (int)cudaErrorInvalidValue;
    staged += mtt_mma_tiles(m.dims[l]) * n_tiles * 64;
    if (m.boff[l] != staged) return (int)cudaErrorInvalidValue;
    staged += 8 * n_tiles;
  }
  if (staged != m.w_floats || m.smem_bytes != m.w_floats * 4) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Host: make `device` current, give `kernel` smem_bytes of dynamic shared
// memory and read its resident blocks per SM into *blocks.
template <typename Args>
static inline cudaError_t mtt_mma_occupancy(void (*kernel)(const Args), int smem_bytes,
                                            int device, int* blocks) {
  // This library links its own CUDA runtime, whose current device is not
  // PyTorch's: set it from the caller's tensors.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, MTT_MMA_THREADS,
                                                       smem_bytes);
}

// Host: launch `kernel` (MTT_MMA_THREADS threads, smem_bytes of dynamic shared
// memory, warps walking tiles of rows_per_warp points) with one resident wave
// of blocks, or fewer when n is small, on `stream` of `device`; returns
// cudaGetLastError() of the launch.
template <typename Args>
static inline int mtt_mma_launch(void (*kernel)(const Args), const Args& a, long long n,
                                 int rows_per_warp, int smem_bytes, int device,
                                 void* stream) {
  if (n == 0) return 0;
  int sms = 0, occ = 0;
  cudaError_t e = mtt_mma_occupancy(kernel, smem_bytes, device, &occ);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  const long long rows_per_block = (long long)rows_per_warp * MTT_MMA_WARPS;
  const long long tiles = (n + rows_per_block - 1) / rows_per_block;
  const long long wave = (long long)sms * occ;
  const int blocks = (int)(tiles < wave ? tiles : wave);
  kernel<<<blocks, MTT_MMA_THREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// The compile-time maxima, for the wrapper to check its mirror of them.
void mtt_limits(int* out3) {
  out3[0] = MTT_MAX_LEVELS;
  out3[1] = MTT_MAX_LAYERS;
  out3[2] = MTT_MAX_WIDTH;
}

}  // extern "C"
