// Designs of the interp forward that the shipped kernel
// (miso_tpu_torch/csrc/grid_interp.cu) is measured against, and a probe of
// the card's L2 gather rate; built and run by scripts/interp_fwd_variants.py.
// The shipped entry points come along with the include, so one library holds
// them all.
//
//   * vf_probe: n threads, each summing random float4 of a table into one
//     float4 it writes: LOADS random float4 (MODE 0), LOADS / 2 random pairs
//     of float4 aligned to 32 bytes, one L2 sector each (MODE 1), or LOADS / 2
//     pairs starting at a random float4, as a point's corner pairs along axis
//     2 lie (MODE 2).  Indices come from a hash of the thread and the load.
//   * vf_ilp<PPT>: one thread takes PPT points (stride: all threads of the
//     grid), works out every corner first and issues all 8 * PPT row loads
//     before it sums any; F = 4 only.
//   * vf_l2_generic: the shipped L2 kernel without its compile-time F = 4.
//   * vf_pairs: the shipped paired path for any F % 4 == 0 (a pair is 2F
//     floats; the shipped one takes F = 4 only).
//   * vf_staged256: the shipped staged kernel in blocks of 256 threads, one
//     wave of as many as fit an SM (up to 8), F = 4.

#include "grid_interp.cu"

#define VF_THREADS 256

__device__ __forceinline__ unsigned vf_hash(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void vf_add(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <int LOADS, int MODE>
__global__ void __launch_bounds__(VF_THREADS)
vf_probe_kernel(const float4* __restrict__ table, unsigned rows, long long n,
                float4* __restrict__ out) {
  const long long p = (long long)blockIdx.x * VF_THREADS + threadIdx.x;
  if (p >= n) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (MODE == 0) {
    unsigned r[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) r[j] = vf_hash((unsigned)p * LOADS + j) % rows;
    float4 v[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) v[j] = __ldg(table + r[j]);
#pragma unroll
    for (int j = 0; j < LOADS; ++j) vf_add(acc, v[j]);
  } else {
    constexpr int PAIRS = LOADS / 2;
    unsigned r[PAIRS];
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      r[j] = vf_hash((unsigned)p * PAIRS + j) % (rows - 1);
      if (MODE == 1) r[j] &= ~1u;
    }
    float4 v[LOADS];
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      v[2 * j] = __ldg(table + r[j]);
      v[2 * j + 1] = __ldg(table + r[j] + 1);
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) vf_add(acc, v[j]);
  }
  out[p] = acc;
}

template <int PPT>
__global__ void __launch_bounds__(VF_THREADS)
vf_ilp_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long stride = (long long)gridDim.x * VF_THREADS;
  const long long p0 = (long long)blockIdx.x * VF_THREADS + threadIdx.x;
  int lin[PPT][8];
  float w[PPT][8];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const long long p = p0 + i * stride;
    if (p < a.n) {
      MttAxes ax;
      mtt_point_axes(a, p, ax);
      mtt_corners(ax, a.dims, lin[i], w[i]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        lin[i][c] = 0;
        w[i][c] = 0.f;
      }
    }
  }
  const float4* g4 = reinterpret_cast<const float4*>(a.grid);
  float4 v[PPT][8];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) v[i][c] = __ldg(g4 + lin[i][c]);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const long long p = p0 + i * stride;
    if (p >= a.n) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc.x = fmaf(w[i][c], v[i][c].x, acc.x);
      acc.y = fmaf(w[i][c], v[i][c].y, acc.y);
      acc.z = fmaf(w[i][c], v[i][c].z, acc.z);
      acc.w = fmaf(w[i][c], v[i][c].w, acc.w);
    }
    reinterpret_cast<float4*>(a.out)[p] = acc;
  }
}

// The shipped L2 kernel with F a run-time value even at F = 4.
__global__ void __launch_bounds__(VF_THREADS)
vf_l2_generic_kernel(const __grid_constant__ MttInterpArgs a) {
  const long long p = (long long)blockIdx.x * VF_THREADS + threadIdx.x;
  if (p >= a.n) return;
  mtt_interp_point<false, 0>(a, static_cast<const float*>(a.grid), p);
}

__global__ void __launch_bounds__(VF_THREADS)
vf_pair_pack_kernel(const __grid_constant__ MttInterpArgs a, float* __restrict__ pairs) {
  const long long r = (long long)blockIdx.x * VF_THREADS + threadIdx.x;
  const long long rows = (long long)a.dims[0] * a.dims[1] * a.dims[2];
  if (r >= rows) return;
  const int z = (int)(r % a.dims[2]);
  const int z_hi = min(a.size != nullptr ? a.size[2] : a.dims[2], a.dims[2]) - 1;
  const int q = a.fdim / 4;
  const float4* src = reinterpret_cast<const float4*>(a.grid) + r * q;
  float4* dst = reinterpret_cast<float4*>(pairs) + 2 * r * q;
  for (int i = 0; i < q; ++i) {
    dst[i] = __ldg(src + i);
    dst[q + i] = __ldg(src + (z < z_hi ? q : 0) + i);
  }
}

__global__ void __launch_bounds__(VF_THREADS)
vf_pair_gather_kernel(const __grid_constant__ MttInterpArgs a, const float* __restrict__ pairs) {
  const long long p = (long long)blockIdx.x * VF_THREADS + threadIdx.x;
  if (p >= a.n) return;
  MttAxes ax;
  mtt_point_axes(a, p, ax);
  const int i0 = ax.i0[2];
  const int zp = i0 < 0 ? 0 : (i0 > ax.hi[2] ? ax.hi[2] : i0);
  const float wz0 = (i0 >= 0 && i0 < ax.n[2]) ? 1.f - ax.fr[2] : 0.f;
  const float wz1 = (i0 + 1 >= 0 && i0 + 1 < ax.n[2]) ? ax.fr[2] : 0.f;
  const float e0 = i0 < 0 ? wz1 : wz0, e1 = i0 < 0 ? 0.f : wz1;
  long long base[4];
  float wxy[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float wc = 1.f;
    bool ok = true;
    int ic[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int bit = (c >> (1 - k)) & 1;
      const int ik = ax.i0[k] + bit;
      ok = ok && ik >= 0 && ik < ax.n[k];
      ic[k] = ik > ax.hi[k] ? ax.hi[k] : (ik < 0 ? 0 : ik);
      wc *= bit ? ax.fr[k] : 1.f - ax.fr[k];
    }
    base[c] = ((long long)ic[0] * a.dims[1] + ic[1]) * a.dims[2] + zp;
    wxy[c] = ok ? wc : 0.f;
  }
  const int F = a.fdim;
  for (int f = 0; f < F; f += 4) {
    float4 v[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4* pr = reinterpret_cast<const float4*>(pairs + 2 * base[c] * F + f);
      v[2 * c] = __ldg(pr);
      v[2 * c + 1] = __ldg(pr + F / 4);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w0 = wxy[c] * e0, w1 = wxy[c] * e1;
      acc.x = fmaf(w1, v[2 * c + 1].x, fmaf(w0, v[2 * c].x, acc.x));
      acc.y = fmaf(w1, v[2 * c + 1].y, fmaf(w0, v[2 * c].y, acc.y));
      acc.z = fmaf(w1, v[2 * c + 1].z, fmaf(w0, v[2 * c].z, acc.z));
      acc.w = fmaf(w1, v[2 * c + 1].w, fmaf(w0, v[2 * c].w, acc.w));
    }
    *reinterpret_cast<float4*>(static_cast<float*>(a.out) + p * F + f) = acc;
  }
}

__global__ void __launch_bounds__(VF_THREADS)
vf_staged256_kernel(const __grid_constant__ MttInterpArgs a) {
  extern __shared__ float4 smem4[];
  float* table = reinterpret_cast<float*>(smem4);
  mtt_stage_table(static_cast<const float*>(a.grid), table,
                  (long long)a.dims[0] * a.dims[1] * a.dims[2] * a.fdim, threadIdx.x, VF_THREADS);
  __syncthreads();
  for (long long p = (long long)blockIdx.x * VF_THREADS + threadIdx.x; p < a.n;
       p += (long long)gridDim.x * VF_THREADS) {
    mtt_interp_point<true, 4>(a, table, p);
  }
}

static unsigned vf_blocks(long long n) { return (unsigned)((n + VF_THREADS - 1) / VF_THREADS); }

extern "C" {

// mode 0: `loads` random float4 a thread (4 or 8); 1: loads / 2 aligned
// pairs; 2: loads / 2 pairs at any float4.  rows: the table's float4 count.
int vf_probe(const float* table, unsigned rows, long long n, int loads, int mode, float* out,
             int device, void* stream) {
  MTT_TRY(cudaSetDevice(device));
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (n == 0 || rows < 2) return (int)cudaErrorInvalidValue;
  if (mode == 0 && loads == 8) {
    vf_probe_kernel<8, 0><<<vf_blocks(n), VF_THREADS, 0, s>>>(t4, rows, n, o4);
  } else if (mode == 0 && loads == 4) {
    vf_probe_kernel<4, 0><<<vf_blocks(n), VF_THREADS, 0, s>>>(t4, rows, n, o4);
  } else if (mode == 1 && loads == 8) {
    vf_probe_kernel<8, 1><<<vf_blocks(n), VF_THREADS, 0, s>>>(t4, rows, n, o4);
  } else if (mode == 2 && loads == 8) {
    vf_probe_kernel<8, 2><<<vf_blocks(n), VF_THREADS, 0, s>>>(t4, rows, n, o4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// F = 4 with float4 rows and no logical size only.
int vf_ilp(const MttInterpArgs* a, int ppt, int device, void* stream) {
  if (a->fdim != 4 || !a->vec4 || a->size != nullptr) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const cudaStream_t s = (cudaStream_t)stream;
  const long long per_block = (long long)VF_THREADS * ppt;
  const unsigned blocks = (unsigned)((a->n + per_block - 1) / per_block);
  if (ppt == 1) {
    vf_ilp_kernel<1><<<blocks, VF_THREADS, 0, s>>>(*a);
  } else if (ppt == 2) {
    vf_ilp_kernel<2><<<blocks, VF_THREADS, 0, s>>>(*a);
  } else if (ppt == 4) {
    vf_ilp_kernel<4><<<blocks, VF_THREADS, 0, s>>>(*a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// pairs: scratch of 2 * rows * fdim floats.  The pack kernel, then the gather.
int vf_pairs(const MttInterpArgs* a, float* pairs, int device, void* stream) {
  if (a->fdim % 4 != 0 || !a->vec4) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)a->dims[0] * a->dims[1] * a->dims[2];
  vf_pair_pack_kernel<<<vf_blocks(rows), VF_THREADS, 0, s>>>(*a, pairs);
  MTT_TRY(cudaGetLastError());
  vf_pair_gather_kernel<<<vf_blocks(a->n), VF_THREADS, 0, s>>>(*a, pairs);
  return (int)cudaGetLastError();
}

int vf_l2_generic(const MttInterpArgs* a, int device, void* stream) {
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  vf_l2_generic_kernel<<<vf_blocks(a->n), VF_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// F = 4 with float4 rows only; the table must fit a block's shared memory.
int vf_staged256(const MttInterpArgs* a, int device, void* stream) {
  if (a->fdim != 4 || !a->vec4) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  MTT_TRY(cudaSetDevice(device));
  const int smem = a->dims[0] * a->dims[1] * a->dims[2] * 16;
  MTT_TRY(cudaFuncSetAttribute(vf_staged256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int sms = 0, occ = 0;
  MTT_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  MTT_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, vf_staged256_kernel, VF_THREADS,
                                                        smem));
  const long long wave = (long long)sms * (occ < 1 ? 1 : occ);
  const long long tiles = (a->n + VF_THREADS - 1) / VF_THREADS;
  vf_staged256_kernel<<<(unsigned)(tiles < wave ? tiles : wave), VF_THREADS, smem,
                        (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
