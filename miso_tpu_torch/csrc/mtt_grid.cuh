// Trilinear corner indices and weights of one point on one grid level, shared by
// the kernels that read or write feature grids (fused_interp_decode.cu,
// grid_interp.cu).
//
// Exactly ops/interp.py::corner_indices_and_weights: continuous index
// u = (x - lo) / (hi - lo) * n - 0.5 per axis (align_corners=False), corners
// floor(u) and floor(u) + 1, zeros padding (a corner outside [0, n) has weight
// 0), an optional run-time logical size n below the static storage shape (it
// sets validity and clipping; the storage shape sets the strides), corners in
// itertools.product order (axis 0 varies slowest).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mtt_common.cuh"

// Per-axis terms of one point.
struct MttAxes {
  int i0[3];     // floor(u)
  float fr[3];   // u - floor(u)
  int n[3];      // logical size (sets validity)
  int hi[3];     // largest index a corner clips to: min(n, storage) - 1
  float scale[3];  // du/dx = n / (hi - lo)
};

// With round_each_op, u is rounded op by op, as the reference rounds it: a
// multiply and subtract contracted into one FMA can put a point on a cell
// face (u an exact integer there) in the cell below, which moves the
// interpolated value by an ulp but the points' gradient, which jumps across
// the face, by a whole step.  grid_interp.cu rounds each op; the fused
// kernel, whose gradient is a recompute in torch ops, keeps the FMA.
__device__ __forceinline__ void mtt_axes(const float xp[3], const float lo[3],
                                         const float ext[3], const int dims[3],
                                         const int32_t* size, MttAxes& a,
                                         bool round_each_op = false) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int nk = size != nullptr ? size[k] : dims[k];
    const float u = round_each_op
        ? __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(xp[k], lo[k]), ext[k]), (float)nk), 0.5f)
        : (xp[k] - lo[k]) / ext[k] * (float)nk - 0.5f;
    const float f0 = floorf(u);
    a.i0[k] = (int)f0;
    a.fr[k] = u - f0;
    a.n[k] = nk;
    // Clip to the logical size (as JAX does) and never past storage.
    a.hi[k] = min(nk, dims[k]) - 1;
    a.scale[k] = (float)nk / ext[k];
  }
}

// The 8 corners: flat row index into the (dims[0], dims[1], dims[2]) storage,
// weight with the zeros-padding validity folded in, and the validity bits
// (bit c set when corner c lies inside the logical grid).
__device__ __forceinline__ unsigned mtt_corners(const MttAxes& a, const int dims[3],
                                                int lin[8], float w[8]) {
  const int stride[3] = {dims[1] * dims[2], dims[2], 1};
  unsigned valid = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float wc = 1.f;
    bool ok = true;
    int li = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int bit = (c >> (2 - k)) & 1;
      const int ik = a.i0[k] + bit;
      ok = ok && ik >= 0 && ik < a.n[k];
      int ic = ik > a.hi[k] ? a.hi[k] : ik;
      ic = ic < 0 ? 0 : ic;
      li += ic * stride[k];
      wc *= bit ? a.fr[k] : 1.f - a.fr[k];
    }
    lin[c] = li;
    w[c] = ok ? wc : 0.f;
    valid |= (ok ? 1u : 0u) << c;
  }
  return valid;
}

// d w_c / d x_k for a valid corner c: the sign of the corner on axis k times
// the other two axes' lerp weights, times du_k/dx_k.
__device__ __forceinline__ float mtt_corner_dweight(const MttAxes& a, int c, int k) {
  float d = ((c >> (2 - k)) & 1) ? a.scale[k] : -a.scale[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j == k) continue;
    d *= ((c >> (2 - j)) & 1) ? a.fr[j] : 1.f - a.fr[j];
  }
  return d;
}
