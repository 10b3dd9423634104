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
// shared memory. Each thread keeps two rows of x in registers and runs the
// search of nearest_rows.cuh over them; it writes only int32 ids.
#include "nearest_rows.cuh"

namespace {

using nearest_rows::D;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 2;
constexpr int ROWS_PER_BLOCK = THREADS * ROWS_PER_THREAD;

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
    nearest_rows::load_row(x, ra, n, xa);
    nearest_rows::load_row(x, rb, n, xb);
    int ia, ib;
    nearest_rows::nearest_two(xa, xb, cb4, e2s, k_codes, ia, ib);
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
