// The fused training VQ: its forward (ids, quantized rows, code counts and the
// squared-error sum in one pass) and its codebook gradient (a segment sum).
//
// Replaces: msla_tpu/ops/vq_fused.py:42 _fwd_kernel (vq_fused_fwd_pallas) and
// msla_tpu/ops/vq_fused.py:81 _bwd_kernel (vq_codebook_grad_pallas).
//
// Bounds on an H100, at N = 704,000 rows, K = 512, D = 64:
// - forward: 2*N*K*D = 4.61e10 FLOP for the distances, 0.093 ms at the TF32
//   tensor-core peak (0.279 ms for 3xTF32's three products), and 180.2 MB in
//   (x) + 180.2 MB out (q) + 2.8 MB (ids): 0.108 ms at 3.35 TB/s, so bound by
//   the bytes.
// - codebook gradient: 2.9e7 adds on 180.2 MB of g and 2.8 MB of ids, so it is
//   bound by memory (3.35 TB/s), 0.055 ms. The TPU's one-hot matmul was how
//   the TPU did the sum, not work the function needs.
//
// Forward design: K3's search (vq_search.cuh: 3xTF32 on mma.sync, the argmin
// folded in registers, the first index on ties as the TPU kernel's
// `dist <= m` then min-lane), a warp a 32-row tile. Then, per tile, with each
// lane holding one row's code:
// - q is the chosen codebook row copied from the fp32 codebook in shared
//   memory: exact, as the TPU's one-hot matmul is, with no matmul and never
//   rebuilt from the split parts. 16 lanes x 16 B write a row, so every store
//   is a whole 256 B row;
// - the code is counted in a per-block shared-memory histogram, one int atomic
//   per group of lanes that picked the same code (__match_any_sync); each
//   block adds its histogram to global int counts (integers: exact in any
//   order);
// - (q - x)^2 is summed from the exact fp32 x (the tile in shared memory, not
//   its split parts), per row in fp32 in a fixed order (4 products a lane, then
//   a fixed tree over the row's 16 lanes) and per thread in fp64, reduced per
//   block in a fixed order into a per-block partial, and the partials are
//   summed in block order by a last one-block kernel: deterministic (a warp's
//   tiles follow from the grid, which the card's SM count fixes).
// The x tile holds the exact x until that sum is taken, so the copy of the
// warp's next tile starts after it, not under the search as in K3.
//
// Codebook gradient: segment_sum.cuh (the design shared with #9's split2
// gradient: TMA-fed, sorted per 32-row group, one fixed order, no atomics).
#include "segment_sum.cuh"
#include "vq_common.cuh"
#include "vq_search.cuh"

namespace {

using vq_common::FULL;

constexpr int D = 64;

// ---- forward ------------------------------------------------------------------

// The warp's rows row0 .. row0 + 31 (row r's code in lane r) take their codes'
// codebook rows; returns the lane's share of sum (q - x)^2 over those rows.
template <int DD>
__device__ __forceinline__ double store_rows(float* __restrict__ q, const float* es,
                                             const float* xs, long long row0, long long n,
                                             int code, int lane) {
  static_assert(DD % 64 == 0, "16 lanes take a row's 16-byte chunks");
  using vq_search::chunk;
  float4* q4 = reinterpret_cast<float4*>(q);
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < vq_search::ROWS / 2; ++s) {
    const int r = 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const long long row = row0 + r;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < DD / 64; ++i) {
      const int ch = 16 * i + (lane & 15);
      const float4 e = chunk(es, c, ch, DD), v = chunk(xs, r, ch, DD);
      if (row < n) q4[row * (DD / 4) + ch] = e;
      const float dx = e.x - v.x, dy = e.y - v.y, dz = e.z - v.z, dw = e.w - v.w;
      part = fmaf(dx, dx, part);
      part = fmaf(dy, dy, part);
      part = fmaf(dz, dz, part);
      part = fmaf(dw, dw, part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if ((lane & 15) == 0 && row < n) acc += (double)part;
  }
  return acc;
}

template <int DD>
__global__ void __launch_bounds__(vq_search::THREADS, 1)
vq_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                    const float* __restrict__ e2, float* __restrict__ q,
                    int* __restrict__ idx, int* __restrict__ counts_i,
                    double* __restrict__ sq_part, long long n, int k_codes) {
  using namespace vq_search;
  extern __shared__ float4 fwd_smem4[];
  const int kpad = padded_codes(k_codes);
  float* es = reinterpret_cast<float*>(fwd_smem4);   // [kpad][DD], swizzled
  float* e2s = es + (size_t)kpad * DD;               // [kpad]
  float* tiles_s = e2s + kpad;                       // [WARPS][ROWS][DD], swizzled
  int* hist = reinterpret_cast<int*>(tiles_s + WARPS * ROWS * DD);  // [K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = tiles_s + warp * ROWS * DD;

  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile < tiles) load_tile<DD>(xs, x, tile * ROWS, n, lane);  // under the codebook's load
  load_codebook<DD>(es, e2s, cb, e2, k_codes);
  for (int i = tid; i < k_codes; i += THREADS) hist[i] = 0;
  __syncthreads();

  double acc = 0.0;
  for (; tile < tiles; tile += stride) {
    wait_tile();
    RowFrags<DD> a;
    a.load(xs, lane);
    int arg[MT][2];
    search(a, xs, es, e2s, kpad, lane, arg);
    const int code = code_of_lane(arg, lane);
    const long long row0 = tile * ROWS;
    const bool valid = row0 + lane < n;
    if (valid) idx[row0 + lane] = code;
    vq_common::count(hist, code, valid, lane);
    acc += store_rows<DD>(q, es, xs, row0, n, code, lane);
    __syncwarp();
    if (tile + stride < tiles) load_tile<DD>(xs, x, (tile + stride) * ROWS, n, lane);
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

}  // namespace

// q (n, D), idx (n,), counts (K,) and sq () are the outputs; counts_i (K,) int
// and sq_part (max_parts,) double are scratch. k_codes must be even; the
// wrapper checks it and that vq_search::smem_bytes<64>(K, true) fit.
extern "C" int vq_fused_fwd(const float* x, const float* cb, const float* e2, float* q,
                            int* idx, float* counts, float* sq, int* counts_i,
                            double* sq_part, int max_parts, long long n, int k_codes,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  using vq_search::ROWS;
  using vq_search::WARPS;
  const size_t smem = vq_search::smem_bytes<D>(k_codes, true);
  const long long blocks = ((n + ROWS - 1) / ROWS + WARPS - 1) / WARPS;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_fused_fwd_kernel<D>, smem, counts_i, k_codes, blocks,
                                   max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_fused_fwd_kernel<D><<<grid, vq_search::THREADS, smem, s>>>(x, cb, e2, q, idx, counts_i,
                                                                   sq_part, n, k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

// The most clusters of the codebook-gradient kernel at K codes that run at once.
extern "C" int vq_codebook_grad_clusters(int k_codes, int* clusters) {
  return segsum::max_clusters<false>(k_codes, clusters);
}

// g (n, D) fp32 and idx (n,) int32, both 16-byte aligned; dcb (K, D) is the
// output; partials (clusters, K, D) is scratch; part p of the clusters * 4
// blocks takes the rows [p * rows_per_part, ...), a multiple of 64. The
// wrapper checks that ops/vq_fused.py grad_smem_bytes(K) fit (K <= 701).
extern "C" int vq_codebook_grad(const float* g, const int* idx, float* dcb, float* partials,
                                int clusters, long long rows_per_part, long long n, int k_codes,
                                void* stream) {
  return segsum::launch<false>(g, idx, dcb, partials, clusters, rows_per_part, n, k_codes,
                               (cudaStream_t)stream);
}
