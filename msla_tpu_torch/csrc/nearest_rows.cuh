// The L2 nearest-code search of vq_lean.cu (#8) alone, on the fp32 FMA units:
// two rows of x held in registers against a codebook and its |e|^2 in shared
// memory. K3 and #4 search on the tensor cores (vq_search.cuh).
//
// dist = |e_k|^2 - 2 x . e_k (|x|^2 is constant per row and dropped), the
// expression of the TPU kernels, in fp32 FMA. Codes are walked two at a time,
// so each shared-memory read (a warp-wide broadcast) feeds two FMAs and four
// independent FMA chains hide the FMA latency. A strict < in ascending k keeps
// the first index among equal minima. No tensor cores: TF32 flips indices on
// near-ties.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nearest_rows {

constexpr int D = 64;

__device__ __forceinline__ void load_row(const float* __restrict__ x, long long row,
                                         long long n, float (&xr)[D]) {
  if (row < n) {
    const float4* p = reinterpret_cast<const float4*>(x + row * D);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 v = p[i];
      xr[4 * i] = v.x; xr[4 * i + 1] = v.y; xr[4 * i + 2] = v.z; xr[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) xr[i] = 0.0f;
  }
}

// ia, ib: the nearest code of rows xa, xb. k_codes must be even.
__device__ __forceinline__ void nearest_two(const float (&xa)[D], const float (&xb)[D],
                                            const float4* __restrict__ cb4,
                                            const float* __restrict__ e2s, int k_codes,
                                            int& ia, int& ib) {
  float best_a = CUDART_INF_F, best_b = CUDART_INF_F;
  ia = 0;
  ib = 0;
  for (int k = 0; k < k_codes; k += 2) {
    float da0 = 0.0f, da1 = 0.0f, db0 = 0.0f, db1 = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 e0 = cb4[k * (D / 4) + i];
      const float4 e1 = cb4[(k + 1) * (D / 4) + i];
      da0 = fmaf(xa[4 * i], e0.x, da0); da0 = fmaf(xa[4 * i + 1], e0.y, da0);
      da0 = fmaf(xa[4 * i + 2], e0.z, da0); da0 = fmaf(xa[4 * i + 3], e0.w, da0);
      da1 = fmaf(xa[4 * i], e1.x, da1); da1 = fmaf(xa[4 * i + 1], e1.y, da1);
      da1 = fmaf(xa[4 * i + 2], e1.z, da1); da1 = fmaf(xa[4 * i + 3], e1.w, da1);
      db0 = fmaf(xb[4 * i], e0.x, db0); db0 = fmaf(xb[4 * i + 1], e0.y, db0);
      db0 = fmaf(xb[4 * i + 2], e0.z, db0); db0 = fmaf(xb[4 * i + 3], e0.w, db0);
      db1 = fmaf(xb[4 * i], e1.x, db1); db1 = fmaf(xb[4 * i + 1], e1.y, db1);
      db1 = fmaf(xb[4 * i + 2], e1.z, db1); db1 = fmaf(xb[4 * i + 3], e1.w, db1);
    }
    const float ea = e2s[k], eb = e2s[k + 1];
    float d;
    d = ea - 2.0f * da0; if (d < best_a) { best_a = d; ia = k; }
    d = eb - 2.0f * da1; if (d < best_a) { best_a = d; ia = k + 1; }
    d = ea - 2.0f * db0; if (d < best_b) { best_b = d; ib = k; }
    d = eb - 2.0f * db1; if (d < best_b) { best_b = d; ib = k + 1; }
  }
}

// The dist of row xr to code k, |e_k|^2 - 2 x . e_k, summed in the order
// nearest_two sums it: for the chosen code, the same bits as its minimum.
__device__ __forceinline__ float dist_to(const float (&xr)[D], const float4* __restrict__ cb4,
                                         const float* __restrict__ e2s, int k) {
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 e = cb4[k * (D / 4) + i];
    dot = fmaf(xr[4 * i], e.x, dot); dot = fmaf(xr[4 * i + 1], e.y, dot);
    dot = fmaf(xr[4 * i + 2], e.z, dot); dot = fmaf(xr[4 * i + 3], e.w, dot);
  }
  return e2s[k] - 2.0f * dot;
}

}  // namespace nearest_rows
