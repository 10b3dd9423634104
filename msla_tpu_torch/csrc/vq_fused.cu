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
#include "vq_common.cuh"
#include "vq_search.cuh"

namespace {

using vq_common::add4;
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
