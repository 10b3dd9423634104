// The lean fused-VQ forward: ids, code counts and the squared-error sum, with
// no quantized rows and no (q - x)^2 pass.
//
// Replaces: tools/bench_vq_lean.py:32 _lean_kernel (vq_lean_fwd), the
// measurement variant of the fused forward (vq_fused.cu's #4) that derives
// the loss sum algebraically, |q - x|^2 = |x|^2 + min_k(|e_k|^2 - 2 x . e_k),
// and leaves q = codebook[idx] to a gather outside the kernel.
//
// Bound on an H100, at N = 704,000 rows, K = 512, D = 64: 2*N*K*D = 4.61e10
// fp32 FLOP for the distances over 180.2 MB in (x) and 2.8 MB out (ids):
// bound by the fp32 FMA rate (67 TFLOP/s outside the tensor cores), 0.69 ms,
// the bound of #4 too. The TPU variant saved an MXU one-hot matmul; #4 has no
// matmul to save (it copies q from shared memory), so on this card the lean
// form drops only #4's q stores (180 MB, hidden under its FMAs) and its
// diff^2 pass per row, against the |x|^2 and m passes here (64 FMAs each).
//
// Design: #4's kernel without q. Persistent blocks, each with the codebook
// and |e|^2 in shared memory and two rows per thread in registers;
// nearest_rows.cuh's search finds the first index of the minimum dist (strict
// < in ascending k: the TPU kernel's `dist <= m` then min-lane), and m is that
// code's dist summed again in the search's order, so the same bits (one more
// 64-FMA dot a row, where #4 has its diff^2 pass; the search itself stays
// #4's and K3's code). Each valid row adds |x|^2 + m (fp32, the TPU's
// expression and its cancellation: when q ~ x the two terms are ~|x|^2 and
// the result is ~0) to an fp64 per-thread sum; counts and the sum are
// deterministic as in #4 (vq_common.cuh).
#include "nearest_rows.cuh"
#include "vq_common.cuh"

namespace {

using nearest_rows::D;

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 2 * THREADS;  // two rows per thread

__device__ __forceinline__ float sq_norm(const float (&xr)[D]) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(xr[d], xr[d], s);
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
vq_lean_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                   const float* __restrict__ e2, int* __restrict__ idx,
                   int* __restrict__ counts_i, double* __restrict__ sq_part, long long n,
                   int k_codes) {
  extern __shared__ float smem[];
  float* cbs = smem;                                   // [K][D]
  float* e2s = cbs + (size_t)k_codes * D;              // [K]
  int* hist = reinterpret_cast<int*>(e2s + k_codes);   // [K]

  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < k_codes * D; i += THREADS) cbs[i] = cb[i];
  for (int i = tid; i < k_codes; i += THREADS) {
    e2s[i] = e2[i];
    hist[i] = 0;
  }
  __syncthreads();
  const float4* cb4 = reinterpret_cast<const float4*>(cbs);

  double acc = 0.0;
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long ra = blk * ROWS_PER_BLOCK + tid;
    const long long rb = ra + THREADS;
    float xa[D], xb[D];
    nearest_rows::load_row(x, ra, n, xa);
    nearest_rows::load_row(x, rb, n, xb);
    int ia, ib;
    nearest_rows::nearest_two(xa, xb, cb4, e2s, k_codes, ia, ib);
    if (ra < n) {
      idx[ra] = ia;
      acc += (double)(sq_norm(xa) + nearest_rows::dist_to(xa, cb4, e2s, ia));
    }
    if (rb < n) {
      idx[rb] = ib;
      acc += (double)(sq_norm(xb) + nearest_rows::dist_to(xb, cb4, e2s, ib));
    }
    vq_common::count(hist, ia, ra < n, lane);
    vq_common::count(hist, ib, rb < n, lane);
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

}  // namespace

// idx (n,), counts (K,) and sq () are the outputs; counts_i (K,) int and
// sq_part (max_parts,) double are scratch. k_codes must be even; the wrapper
// checks it and that K*(D+2)*4 bytes fit in shared memory.
extern "C" int vq_lean_fwd(const float* x, const float* cb, const float* e2, int* idx,
                           float* counts, float* sq, int* counts_i, double* sq_part,
                           int max_parts, long long n, int k_codes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)k_codes * (D + 2) * sizeof(float);
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_lean_fwd_kernel, smem, counts_i, k_codes, blocks,
                                   max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_lean_fwd_kernel<<<grid, THREADS, smem, s>>>(x, cb, e2, idx, counts_i, sq_part, n,
                                                   k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}
