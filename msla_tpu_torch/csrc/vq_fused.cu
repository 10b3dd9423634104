// The fused training VQ: its forward (ids, quantized rows, code counts and the
// squared-error sum in one pass) and its codebook gradient (a segment sum).
//
// Replaces: msla_tpu/ops/vq_fused.py:42 _fwd_kernel (vq_fused_fwd_pallas) and
// msla_tpu/ops/vq_fused.py:81 _bwd_kernel (vq_codebook_grad_pallas).
//
// Bounds on an H100, at N = 704,000 rows, K = 512, D = 64:
// - forward: 2*N*K*D = 4.61e10 fp32 FLOP for the distances, and 180.2 MB in
//   (x) + 180.2 MB out (q) + 2.8 MB (ids): bound by the fp32 FMA rate
//   (67 TFLOP/s outside the tensor cores), 0.69 ms.
// - codebook gradient: 2.9e7 adds on 180.2 MB of g and 2.8 MB of ids, so it is
//   bound by memory (3.35 TB/s), 0.055 ms. The TPU's one-hot matmul was how
//   the TPU did the sum, not work the function needs.
//
// Forward design: K3's (nearest_codes.cu) persistent blocks, each with the
// codebook and |e|^2 in shared memory and two rows per thread in registers,
// with a strict < in ascending k (the first index on ties, as the TPU kernel's
// `dist <= m` then min-lane). Then, per row:
// - q is the chosen codebook row copied from shared memory: exact, as the TPU's
//   one-hot matmul is, with no matmul. A warp writes its 32 rows together,
//   16 lanes x float4 per row, so every store is a whole 256 B row;
// - the code is counted in a per-block shared-memory histogram, one int atomic
//   per group of lanes that picked the same code (__match_any_sync); each
//   block adds its histogram to global int counts (integers: exact in any
//   order);
// - (q - x)^2 is summed per row in fp32 and per thread in fp64, reduced per
//   block in a fixed order into a per-block partial, and the partials are
//   summed in block order by a last one-block kernel: deterministic.
//
// Codebook-gradient design: dcb[k] = sum of g rows whose id is k. At init and
// early in training most rows pick a handful of codes, so one shared-memory
// atomic per (row, d) would serialise on a few addresses. Instead each of a
// block's 8 warps owns 8 of the 64 columns (a 32 B sector per row) of a
// per-block (K, D) accumulator in shared memory, and lanes map to rows: a warp
// reads 32 rows' sectors at once, groups the lanes that share a code
// (__match_any_sync), and the group's lowest lane adds the group's values in
// lane order into the accumulator. No warp ever touches another warp's
// columns, so there are no atomics and the order of every sum is fixed. Each
// block takes one contiguous run of rows and writes its accumulator as a
// partial; a second kernel sums the partials in block order. Deterministic.
#include "nearest_rows.cuh"
#include "vq_common.cuh"

namespace {

using nearest_rows::D;
using vq_common::add4;
using vq_common::FULL;

// ---- forward ------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 2 * THREADS;  // two rows per thread

// The 32 consecutive rows row0.. of a warp take their codes' codebook rows.
__device__ __forceinline__ void store_rows(float4* __restrict__ q4,
                                           const float4* __restrict__ cb4, long long row0,
                                           long long n, int code, int lane) {
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int r = 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const long long row = row0 + r;
    if (row < n) q4[row * (D / 4) + (lane & 15)] = cb4[c * (D / 4) + (lane & 15)];
  }
}

__device__ __forceinline__ float sq_err(const float (&xr)[D], const float* __restrict__ e) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float diff = e[d] - xr[d];
    s = fmaf(diff, diff, s);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
vq_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                    const float* __restrict__ e2, float* __restrict__ q,
                    int* __restrict__ idx, int* __restrict__ counts_i,
                    double* __restrict__ sq_part, long long n, int k_codes) {
  extern __shared__ float smem[];
  float* cbs = smem;                                   // [K][D]
  float* e2s = cbs + (size_t)k_codes * D;              // [K]
  int* hist = reinterpret_cast<int*>(e2s + k_codes);   // [K]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < k_codes * D; i += THREADS) cbs[i] = cb[i];
  for (int i = tid; i < k_codes; i += THREADS) {
    e2s[i] = e2[i];
    hist[i] = 0;
  }
  __syncthreads();
  const float4* cb4 = reinterpret_cast<const float4*>(cbs);
  float4* q4 = reinterpret_cast<float4*>(q);

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
      acc += sq_err(xa, cbs + ia * D);
    }
    if (rb < n) {
      idx[rb] = ib;
      acc += sq_err(xb, cbs + ib * D);
    }
    vq_common::count(hist, ia, ra < n, lane);
    vq_common::count(hist, ib, rb < n, lane);
    const long long warp_row = blk * ROWS_PER_BLOCK + warp * 32;
    store_rows(q4, cb4, warp_row, n, ia, lane);
    store_rows(q4, cb4, warp_row + THREADS, n, ib, lane);
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

// ---- codebook gradient ----------------------------------------------------------

constexpr int GRAD_THREADS = 256;          // 8 warps; warp w owns columns [8w, 8w+8)
constexpr int COLS = D / (GRAD_THREADS / 32);
constexpr int ACC_STRIDE = D + 4;          // padded rows: leaders of one warp that
                                           // picked different codes hit other banks

struct RowSlice {
  int code;      // -1 past the block's rows
  float4 lo, hi; // the warp's 8 columns of the row
};

__device__ __forceinline__ RowSlice fetch(const float* __restrict__ g,
                                          const int* __restrict__ idx, long long row,
                                          long long end, int warp) {
  RowSlice s{-1, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if (row < end) {
    s.code = idx[row];
    const float4* p = reinterpret_cast<const float4*>(g + row * D + COLS * warp);
    s.lo = p[0];
    s.hi = p[1];
  }
  return s;
}

__global__ void __launch_bounds__(GRAD_THREADS, 1)
vq_codebook_grad_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                        float* __restrict__ partials, long long n, int k_codes,
                        long long rows_per_block) {
  extern __shared__ float smem[];
  float* acc = smem;                                                     // [K][ACC_STRIDE]
  float4* stage = reinterpret_cast<float4*>(acc + (size_t)k_codes * ACC_STRIDE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < k_codes * ACC_STRIDE; i += GRAD_THREADS) acc[i] = 0.0f;
  __syncthreads();
  float4* st = stage + warp * 64;  // [2][32]: lo then hi of each lane's row

  const long long begin = (long long)blockIdx.x * rows_per_block;
  const long long end = begin + rows_per_block < n ? begin + rows_per_block : n;
  RowSlice cur = fetch(g, idx, begin + lane, end, warp);
  for (long long r0 = begin; r0 < end; r0 += 32) {
    const RowSlice next = fetch(g, idx, r0 + 32 + lane, end, warp);  // in flight meanwhile
    st[lane] = cur.lo;
    st[32 + lane] = cur.hi;
    const bool valid = (unsigned)cur.code < (unsigned)k_codes;
    const unsigned peers = __match_any_sync(FULL, valid ? cur.code : -1);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      for (unsigned m = peers; m; m &= m - 1) {  // ascending lanes: a fixed order
        const int j = __ffs(m) - 1;
        add4(lo, st[j]);
        add4(hi, st[32 + j]);
      }
      float4* a = reinterpret_cast<float4*>(acc + (size_t)cur.code * ACC_STRIDE + COLS * warp);
      add4(a[0], lo);
      add4(a[1], hi);
    }
    __syncwarp();
    cur = next;
  }
  __syncthreads();

  float* out = partials + (size_t)blockIdx.x * k_codes * D;
  for (int i = tid; i < k_codes * D; i += GRAD_THREADS)
    out[i] = acc[(i / D) * ACC_STRIDE + i % D];
}

}  // namespace

// q (n, D), idx (n,), counts (K,) and sq () are the outputs; counts_i (K,) int
// and sq_part (max_parts,) double are scratch. k_codes must be even; the
// wrapper checks it and that K*(D+2)*4 bytes fit in shared memory.
extern "C" int vq_fused_fwd(const float* x, const float* cb, const float* e2, float* q,
                            int* idx, float* counts, float* sq, int* counts_i,
                            double* sq_part, int max_parts, long long n, int k_codes,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)k_codes * (D + 2) * sizeof(float);
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_fused_fwd_kernel, smem, counts_i, k_codes, blocks,
                                   max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_fused_fwd_kernel<<<grid, THREADS, smem, s>>>(x, cb, e2, q, idx, counts_i, sq_part, n,
                                                    k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

// dcb (K, D) is the output; partials (max_parts, K, D) is scratch. The wrapper
// checks that K*(D+4)*4 + 8 KB bytes fit in shared memory.
extern "C" int vq_codebook_grad(const float* g, const int* idx, float* dcb, float* partials,
                                int max_parts, long long n, int k_codes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)k_codes * ACC_STRIDE * sizeof(float) +
                      (GRAD_THREADS / 32) * 64 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      vq_codebook_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (int e = vq_common::sm_count(&sms)) return e;
  long long grid = (n + 31) / 32;  // at least 32 rows a block
  if (grid > sms) grid = sms;
  if (grid > max_parts) grid = max_parts;
  if (grid > 0) {
    long long rows = (n + grid - 1) / grid;
    rows = (rows + 31) / 32 * 32;
    vq_codebook_grad_kernel<<<(int)grid, GRAD_THREADS, smem, s>>>(g, idx, partials, n,
                                                                  k_codes, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int kd = k_codes * D;
  vq_common::grad_reduce_kernel<<<(kd + 255) / 256, 256, 0, s>>>(partials, (int)grid, kd, 1,
                                                                 dcb);
  return (int)cudaGetLastError();
}
