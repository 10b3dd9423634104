// The lean fused-VQ forward: ids, code counts and the squared-error sum, with
// no quantized rows and no (q - x)^2 pass.
//
// Replaces: tools/bench_vq_lean.py:32 _lean_kernel (vq_lean_fwd), the
// measurement variant of the fused forward (vq_fused.cu's #4) that derives
// the loss sum algebraically, |q - x|^2 = |x|^2 + min_k(|e_k|^2 - 2 x . e_k),
// and leaves q = codebook[idx] to a gather outside the kernel.
//
// Bound on an H100, at N = 704,000 rows, K = 512, D = 64: 2*N*K*D = 4.61e10
// FLOP for the distances, 0.093 ms at the TF32 tensor-core peak (0.279 ms for
// 3xTF32's three products; 0.689 ms on the fp32 FMA units, where the first
// design of this kernel searched), over 180.2 MB in (x) and 2.8 MB out (ids):
// 0.055 ms at 3.35 TB/s. So bound by operations. The TPU variant saved an MXU
// one-hot matmul; on this card the lean form saves #4's q stores (180 MB) and
// its diff^2 pass, against one more dot a row.
//
// Design: #4's kernel without q. K3's and #4's search (vq_search.cuh: 3xTF32
// on mma.sync, the argmin folded in registers, the first index among equal
// minima as the TPU kernel's `dist <= m` then min-lane), a warp a 32-row tile
// of a persistent block. Then, per tile, with each lane holding one row's
// code: the id is stored, the code counted in the block's histogram, and each
// valid row adds |x|^2 + m to an fp64 per-thread sum, where m = |e_c|^2 - 2 x
// . e_c is taken again in fp32 FMA from the exact x tile and the fp32
// codebook in shared memory (16 lanes x 4 columns a row, then a fixed tree):
// the TPU's expression and its cancellation (when q ~ x the two terms are
// ~|x|^2 and the result ~0). So, as in #4, the x tile holds the exact x until
// the epilogue has read it, and the copy of the warp's next tile starts after.
// Counts and the sum are deterministic as in #4 (vq_common.cuh).
#include "vq_common.cuh"
#include "vq_search.cuh"

namespace {

using vq_common::FULL;

constexpr int D = 64;

// The warp's rows row0 .. row0 + 31 (row r's code in lane r): the lane's share
// of the sum over the valid rows of |x|^2 + |e_c|^2 - 2 x . e_c.
__device__ __forceinline__ double lean_rows(const float* es, const float* e2s, const float* xs,
                                            long long row0, long long n, int code, int lane) {
  using vq_search::chunk;
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < vq_search::ROWS / 2; ++s) {
    const int r = 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const float4 e = chunk(es, c, lane & 15, D), v = chunk(xs, r, lane & 15, D);
    float x2 = v.x * v.x, dot = v.x * e.x;
    x2 = fmaf(v.y, v.y, x2);
    dot = fmaf(v.y, e.y, dot);
    x2 = fmaf(v.z, v.z, x2);
    dot = fmaf(v.z, e.z, dot);
    x2 = fmaf(v.w, v.w, x2);
    dot = fmaf(v.w, e.w, dot);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      x2 += __shfl_xor_sync(FULL, x2, off);
      dot += __shfl_xor_sync(FULL, dot, off);
    }
    if ((lane & 15) == 0 && row0 + r < n) acc += (double)(x2 + (e2s[c] - 2.0f * dot));
  }
  return acc;
}

__global__ void __launch_bounds__(vq_search::THREADS, 1)
vq_lean_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                   const float* __restrict__ e2, int* __restrict__ idx,
                   int* __restrict__ counts_i, double* __restrict__ sq_part, long long n,
                   int k_codes) {
  using namespace vq_search;
  extern __shared__ float4 lean_smem4[];
  const int kpad = padded_codes(k_codes);
  float* es = reinterpret_cast<float*>(lean_smem4);  // [kpad][D], swizzled
  float* e2s = es + (size_t)kpad * D;                // [kpad]
  float* tiles_s = e2s + kpad;                       // [WARPS][ROWS][D], swizzled
  int* hist = reinterpret_cast<int*>(tiles_s + WARPS * ROWS * D);  // [K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = tiles_s + warp * ROWS * D;

  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile < tiles) load_tile<D>(xs, x, tile * ROWS, n, lane);  // under the codebook's load
  load_codebook<D>(es, e2s, cb, e2, k_codes);
  for (int i = tid; i < k_codes; i += THREADS) hist[i] = 0;
  __syncthreads();

  double acc = 0.0;
  for (; tile < tiles; tile += stride) {
    wait_tile();
    RowFrags<D> a;
    a.load(xs, lane);
    int arg[MT][2];
    search(a, xs, es, e2s, kpad, lane, arg);
    const int code = code_of_lane(arg, lane);
    const long long row0 = tile * ROWS;
    const bool valid = row0 + lane < n;
    if (valid) idx[row0 + lane] = code;
    vq_common::count(hist, code, valid, lane);
    acc += lean_rows(es, e2s, xs, row0, n, code, lane);
    __syncwarp();
    if (tile + stride < tiles) load_tile<D>(xs, x, (tile + stride) * ROWS, n, lane);
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

}  // namespace

// idx (n,), counts (K,) and sq () are the outputs; counts_i (K,) int and
// sq_part (max_parts,) double are scratch. k_codes must be even; the wrapper
// checks it and that vq_search::smem_bytes<64>(K, true) fit (ops/vq_lean.py
// check_codes).
extern "C" int vq_lean_fwd(const float* x, const float* cb, const float* e2, int* idx,
                           float* counts, float* sq, int* counts_i, double* sq_part,
                           int max_parts, long long n, int k_codes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  using vq_search::ROWS;
  using vq_search::WARPS;
  const size_t smem = vq_search::smem_bytes<D>(k_codes, true);
  const long long blocks = ((n + ROWS - 1) / ROWS + WARPS - 1) / WARPS;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_lean_fwd_kernel, smem, counts_i, k_codes, blocks,
                                   max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_lean_fwd_kernel<<<grid, vq_search::THREADS, smem, s>>>(x, cb, e2, idx, counts_i,
                                                              sq_part, n, k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}
