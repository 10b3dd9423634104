// Nearest-codebook lookup: idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k), lowest
// index on ties; |x_n|^2 is constant per row and dropped.
//
// Replaces: msla_tpu/ops/vq_pallas.py:40 _nearest_codes_kernel
// (nearest_codes_pallas).
//
// Bound on an H100: at N = 704,000 rows, K = 512 codes, D = 64 the lookup does
// 2*N*K*D = 4.61e10 fp32 FLOP and must move 180.2 MB in + 2.8 MB out, so it is
// bound by the fp32 FMA rate (67 TFLOP/s outside the tensor cores).
//
// Design: the (N, K) distance matrix (1.44 GB at that size) never exists. A
// persistent block (one per SM) holds the whole codebook (128 KB) and |e|^2 in
// shared memory. Each thread keeps two rows of x in registers and walks the
// codes two at a time, so each shared-memory read (a warp-wide broadcast)
// feeds two FMAs and four independent FMA chains hide the FMA latency. It
// keeps a running (min, first index) per row and writes only int32 ids.
// The distance is e2[k] - 2 * dot, the expression of the TPU kernel, in fp32
// FMA; no tensor cores, because TF32 flips indices on near-ties.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 2;
constexpr int ROWS_PER_BLOCK = THREADS * ROWS_PER_THREAD;

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

__global__ void __launch_bounds__(THREADS, 1)
nearest_codes_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ e2, int* __restrict__ idx,
                     long long n, int k_codes) {
  extern __shared__ float smem[];
  float* cbs = smem;                    // [K][D]
  float* e2s = cbs + (size_t)k_codes * D;  // [K]
  for (int i = threadIdx.x; i < k_codes * D; i += THREADS) cbs[i] = cb[i];
  for (int i = threadIdx.x; i < k_codes; i += THREADS) e2s[i] = e2[i];
  __syncthreads();
  const float4* cb4 = reinterpret_cast<const float4*>(cbs);

  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long ra = blk * ROWS_PER_BLOCK + threadIdx.x;
    const long long rb = ra + THREADS;
    float xa[D], xb[D];
    load_row(x, ra, n, xa);
    load_row(x, rb, n, xb);

    float best_a = CUDART_INF_F, best_b = CUDART_INF_F;
    int ia = 0, ib = 0;
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
      // strict < in ascending k keeps the first index among equal minima
      const float ea = e2s[k], eb = e2s[k + 1];
      float d;
      d = ea - 2.0f * da0; if (d < best_a) { best_a = d; ia = k; }
      d = eb - 2.0f * da1; if (d < best_a) { best_a = d; ia = k + 1; }
      d = ea - 2.0f * db0; if (d < best_b) { best_b = d; ib = k; }
      d = eb - 2.0f * db1; if (d < best_b) { best_b = d; ib = k + 1; }
    }
    if (ra < n) idx[ra] = ia;
    if (rb < n) idx[rb] = ib;
  }
}

}  // namespace

// k_codes must be even; the wrapper checks it and that K*(D+1)*4 bytes fit.
extern "C" int nearest_codes_fwd(const float* x, const float* cb, const float* e2,
                                 int* idx, long long n, int k_codes, void* stream) {
  const size_t smem = (size_t)k_codes * (D + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int grid = (int)(blocks < sms ? blocks : sms);
  if (grid == 0) return 0;
  nearest_codes_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, cb, e2, idx, n, k_codes);
  return (int)cudaGetLastError();
}
