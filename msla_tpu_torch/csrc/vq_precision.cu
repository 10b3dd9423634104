// The precision variants of the fused VQ forward, with the distance dot on
// bf16 tensor cores, and of its codebook gradient, on a hi/lo bf16 split.
//
// Replaces: tools/bench_vq_precision.py:35 make_fwd(dist_mode, quant_mode)
// for dist_mode "bf16" (x -> bf16 times cb_hi) and "split3" (xh.cbh + xh.cbl +
// xl.cbh), each with quant_mode "f32" (q = cb[idx]) or "split2" (q = cb_hi[idx]
// + cb_lo[idx] in fp32), and :139 make_bwd("split2") (the segment sum of
// bf16(g) and of bf16(g - bf16(g)), in two sums added at the end). The "f32"
// modes compute exactly vq_fused.cu's functions (#4, #5), and the wrappers
// launch those.
//
// Bounds on an H100, at N = 704,000 rows, K = 512, D = 64:
// - forward, bf16: 2*N*K*D = 4.61e10 FLOP on the bf16 tensor cores (989
//   TFLOP/s dense: 0.047 ms) over 180.2 MB in (x) + 180.2 MB out (q) + 2.8 MB
//   (ids): bound by memory (3.35 TB/s), 0.108 ms;
// - forward, split3: three products, 1.38e11 bf16 FLOP: bound by the tensor
//   cores, 0.140 ms;
// - gradient, split2: 2 x 4.5e7 adds on 180.2 MB of g and 2.8 MB of ids:
//   bound by memory, 0.055 ms.
//
// Forward design: the card's route to its tensor cores, wgmma, with x
// streamed under it.
// - Persistent blocks of two warpgroups, one block an SM. A warpgroup takes
//   64-row tiles (wgmma's M), its tile `+= warpgroups in the grid`; warp w of
//   it owns rows 16w .. 16w + 15 of the tile, in the products and in the
//   epilogue alike, so no barrier joins the warps outside the wgmma.
// - Products: wgmma.mma_async m64n256k16, bf16, fp32 accumulators (128
//   registers a thread), 256 codes a product tile. B is the codebook from
//   shared memory: cb_hi, and cb_lo for split3, as the wrapper splits them
//   (ops/vq_precision.py split_bf16), put there once a block in wgmma's
//   K-major layout with the 128-byte swizzle (a 64-value bf16 row is one
//   128-byte swizzle row); codes past K up to a multiple of 256 are zero rows.
//   A comes from registers: each lane rounds its rows' x to bf16 with
//   __float2bfloat16_rn (the RNE of JAX's astype; split3 also xl = bf16(x -
//   xh)) straight into the A fragments (16 registers, 32 for split3), held for
//   the tile. Split3 runs its three products into one accumulator in the
//   order of the first design: xl.hi and xh.lo a k16 step, then xh.hi.
// - x arrives by cp.async, double-buffered: each warp copies its next 16 rows
//   (4 KB of fp32, each 16-byte chunk c of row r at c ^ r % 8, so a quad's
//   fragment reads and a half warp's row reads hit distinct banks) while it
//   runs the current tile's products, fold and epilogue.
// - Fold: mlm_argmax.cuh's fold_tile, the MLM argmax's (a strict > in
//   ascending columns per lane, then a quad combine that takes the smaller
//   index on an equal value), on the value acc - |e|^2 / 2 = -dist / 2:
//   halving and negation commute with fp32 rounding, so its order and ties
//   are those of dist = |e|^2 - 2 acc, the first minimum as the TPU's
//   `dist <= m` then min-lane. -|e|^2 / 2 sits in shared memory, -inf past K.
//   The (N, K) distances never leave registers. A warpgroup folds each tile
//   after its products, while the other warpgroup's run: on an H100 the fold
//   costs 0.05 ms of bf16's 0.20 and 0.12 of split3's 0.27 (bench_stems'
//   "no fold" probe; PERF.md). Two m64n128 accumulators, each tile folded
//   while the next one's products run, were slower: ptxas serialized their
//   wgmmas (C7518, then C7514). Warpgroups that take turns to issue their
//   products (named barriers) took split3 6 % lower and bf16 no lower, not
//   worth the barriers (PERF.md section 7).
// - Epilogue as in #4 (vq_fused.cu): 16 lanes x 16 B write each q row whole,
//   q = float(hi) + float(lo) from the shared codebook (split2) or cb[idx]
//   from L2 (f32: the fp32 codebook, 128 KB more, does not fit beside cb_hi
//   and the x tiles); the code counted in the block's histogram; the exact
//   sum of (q - x)^2 from the fp32 x tile, per row in fp32 in a fixed tree,
//   per thread in fp64, deterministic as in #4 (vq_common.cuh).
// - Shared memory at K = 512: cb_hi 64 KB, cb_lo 64 KB (split3, split2),
//   8 warps' two x tiles 64 KB, -|e|^2 / 2 and the histogram 4 KB: 197 KB;
//   so K up to 512 with cb_lo and 1,024 without (ops/vq_precision.py
//   fwd_smem_bytes).
//
// Gradient design: segment_sum.cuh, shared with #5. Two (K, D) fp32 sums do
// not fit in one block's shared memory, so each block owns half of the
// columns, with the hi sum and the lo sum side by side in its (K, 64)
// accumulator: one consumer warp makes and sums the hi parts, another the lo
// parts, each split in registers (no gl array in device memory). The hi and
// lo sums are reduced apart and added at the end. Deterministic.
#include <cuda_bf16.h>
#include <stdint.h>

#include "mlm_argmax.cuh"
#include "segment_sum.cuh"
#include "vq_common.cuh"

namespace {

using vq_common::FULL;

constexpr int D = 64;
constexpr int DIST_BF16 = 0, DIST_SPLIT3 = 1;   // the wrapper's codes
constexpr int QUANT_F32 = 0, QUANT_SPLIT2 = 1;

// ---- forward ------------------------------------------------------------------

constexpr int WARPS = 8;                    // two warpgroups
constexpr int THREADS = 32 * WARPS;
constexpr int GROUPS = WARPS / 4;
constexpr int TILE_ROWS = 64;               // a warpgroup's tile: wgmma's M
constexpr int WARP_ROWS = 16;               // a warp's rows of it
constexpr int BN = mlm::BN;                 // codes a product tile: wgmma's N, 256
constexpr int ROW_BYTES = D * 2;            // a bf16 codebook row: one 128-byte swizzle row
constexpr int X_TILE = WARP_ROWS * D;       // floats of a warp's x tile (4 KB)
constexpr int K_STEPS = D / 16;

__host__ __device__ constexpr int padded(int k) { return (k + BN - 1) / BN * BN; }

// Dynamic shared memory: cb_hi [kpad][128 B] and, with_lo, cb_lo; the warps'
// x tiles [WARPS][2][16][D] fp32; -|e|^2 / 2 [kpad]; the histogram [kpad];
// and 1 KB to align the codebook to the swizzle's 1,024 B.
__host__ __device__ constexpr size_t fwd_smem_bytes(int k_codes, bool with_lo) {
  return (size_t)padded(k_codes) * (ROW_BYTES * (with_lo ? 2 : 1) + 8) +
         (size_t)2 * WARPS * X_TILE * sizeof(float) + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two fp32 values as a bf16x2 word, a in the low half (the lower column).
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// The low-part word of the same pair: bf16(a - float(bf16(a))), likewise b.
__device__ __forceinline__ uint32_t pack_lo(float a, float b) {
  const uint32_t h = pack(a, b);
  return pack(a - __uint_as_float(h << 16), b - __uint_as_float(h & 0xffff0000u));
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Where column `col` of row r of a warp's fp32 x tile sits.
__device__ __forceinline__ int x_at(int r, int col) {
  return r * D + 4 * ((col >> 2) ^ (r & 7)) + (col & 3);
}

// A (K, D) bf16 codebook into shared memory in the 128-byte swizzle, zero rows
// from K to kpad. Every thread of the block calls it.
__device__ __forceinline__ void load_codes(unsigned char* dst, const uint4* __restrict__ src,
                                           int k_codes, int kpad) {
  for (int i = threadIdx.x; i < kpad * (ROW_BYTES / 16); i += THREADS) {
    const int r = i / (ROW_BYTES / 16), c = i % (ROW_BYTES / 16);
    *reinterpret_cast<uint4*>(dst + r * ROW_BYTES + ((c ^ (r & 7)) << 4)) =
        r < k_codes ? src[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Start the copy of rows row0 .. row0 + 15 of x into a warp's tile (rows past
// n as zeros). Every lane of the warp calls it; the caller commits.
__device__ __forceinline__ void load_rows(float* xs, const float* __restrict__ x, long long row0,
                                          long long n, int lane) {
#pragma unroll
  for (int i = lane; i < WARP_ROWS * (D / 4); i += 32) {
    const int r = i / (D / 4), c = i % (D / 4);
    const long long row = row0 + r;
    mlm::cp_async16(xs + x_at(r, 4 * c), x + (row < n ? row * D + 4 * c : 0), row < n);
  }
}

// The lane's A fragments of its warp's 16 rows, k16 step s: a0 row g, columns
// 16s + 2t, +1; a1 row g + 8; a2, a3 columns + 8. hi = bf16(x), lo = bf16(x -
// hi) (split3).
template <int DIST>
__device__ __forceinline__ void load_a(const float* xs, int lane, uint32_t (&ah)[K_STEPS][4],
                                       uint32_t (&al)[K_STEPS][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < K_STEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i & 1), col = 16 * s + 8 * (i >> 1) + 2 * t;
      const float2 v = *reinterpret_cast<const float2*>(xs + x_at(r, col));
      ah[s][i] = pack(v.x, v.y);
      if (DIST == DIST_SPLIT3) al[s][i] = pack_lo(v.x, v.y);
    }
}

// d = x . e over one tile of 256 codes, whose cb_hi and cb_lo rows start at
// shared addresses hi and lo: split3 runs xl.hi and xh.lo a k16 step, then
// xh.hi, into one accumulator; bf16 runs xh.hi.
template <int DIST>
__device__ __forceinline__ void products(float (&d)[128], uint32_t (&ah)[K_STEPS][4],
                                         uint32_t (&al)[K_STEPS][4], uint32_t hi, uint32_t lo) {
  mlm::fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (DIST == DIST_SPLIT3) {
#pragma unroll
    for (int s = 0; s < K_STEPS; ++s) {
      mlm::wgmma_bf16_rs(d, al[s], mlm::desc128(hi + 32 * s), s != 0);
      mlm::wgmma_bf16_rs(d, ah[s], mlm::desc128(lo + 32 * s), 1);
    }
  }
#pragma unroll
  for (int s = 0; s < K_STEPS; ++s)
    mlm::wgmma_bf16_rs(d, ah[s], mlm::desc128(hi + 32 * s), DIST == DIST_SPLIT3 || s != 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  mlm::fence_acc(d);
  mlm::fence_frag(ah);
  if (DIST == DIST_SPLIT3) mlm::fence_frag(al);
}

// The warp's rows row0 .. row0 + 15 (row r's code in lane r) take their q
// rows, 16 lanes x 16 B a row; returns the lane's share of sum (q - x)^2 over
// them, from the exact fp32 x.
template <int QUANT>
__device__ __forceinline__ double store_rows(float* __restrict__ q, const float* __restrict__ cb,
                                             const unsigned char* hs, const unsigned char* ls,
                                             const float* xs, long long row0, long long n,
                                             int code, int lane) {
  float4* q4 = reinterpret_cast<float4*>(q);
  const int l = lane & 15;  // columns 4l .. 4l + 3
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < WARP_ROWS / 2; ++s) {
    const int r = 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const long long row = row0 + r;
    float4 e;
    if (QUANT == QUANT_F32) {
      e = __ldg(reinterpret_cast<const float4*>(cb) + c * (D / 4) + l);
    } else {  // 4 bf16 of cb_hi and of cb_lo: half of a swizzled 16-byte group
      const int o = c * ROW_BYTES + (((l >> 1) ^ (c & 7)) << 4) + ((l & 1) << 3);
      const uint2 h = *reinterpret_cast<const uint2*>(hs + o);
      const uint2 w = *reinterpret_cast<const uint2*>(ls + o);
      const float2 h0 = unpack(h.x), h1 = unpack(h.y), w0 = unpack(w.x), w1 = unpack(w.y);
      e = make_float4(h0.x + w0.x, h0.y + w0.y, h1.x + w1.x, h1.y + w1.y);
    }
    const float4 v = *reinterpret_cast<const float4*>(xs + x_at(r, 4 * l));
    if (row < n) q4[row * (D / 4) + l] = e;
    const float dx = e.x - v.x, dy = e.y - v.y, dz = e.z - v.z, dw = e.w - v.w;
    float part = dx * dx;
    part = fmaf(dy, dy, part);
    part = fmaf(dz, dz, part);
    part = fmaf(dw, dw, part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if (l == 0 && row < n) acc += (double)part;
  }
  return acc;
}

template <int DIST, int QUANT>
__global__ void __launch_bounds__(THREADS, 1)
vq_precision_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                        const uint4* __restrict__ cbh, const uint4* __restrict__ cbl,
                        const float* __restrict__ e2, float* __restrict__ q,
                        int* __restrict__ idx, int* __restrict__ counts_i,
                        double* __restrict__ sq_part, long long n, int k_codes) {
  constexpr bool WITH_LO = DIST == DIST_SPLIT3 || QUANT == QUANT_SPLIT2;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int kpad = padded(k_codes);
  unsigned char* hs = fwd_smem + ((1024u - (smem_addr(fwd_smem) & 1023u)) & 1023u);
  unsigned char* ls = hs + (size_t)kpad * ROW_BYTES;                  // cb_lo, WITH_LO
  float* xt = reinterpret_cast<float*>(WITH_LO ? ls + (size_t)kpad * ROW_BYTES : ls);
  float* half_e2 = xt + 2 * WARPS * X_TILE;                           // [kpad] -|e|^2 / 2
  int* hist = reinterpret_cast<int*>(half_e2 + kpad);                 // [kpad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  float* xs = xt + warp * 2 * X_TILE;       // this warp's two x tiles
  const int wrow = WARP_ROWS * (warp & 3);  // the warp's first row in its warpgroup's tile

  const long long tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const long long stride = (long long)gridDim.x * GROUPS;
  long long tile = (long long)blockIdx.x * GROUPS + (warp >> 2);
  if (tile < tiles) load_rows(xs, x, tile * TILE_ROWS + wrow, n, lane);  // under the codebook's
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load_codes(hs, cbh, k_codes, kpad);
  if (WITH_LO) load_codes(ls, cbl, k_codes, kpad);
  for (int i = tid; i < kpad; i += THREADS) {
    half_e2[i] = i < k_codes ? -0.5f * e2[i] : -CUDART_INF_F;
    hist[i] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  __syncthreads();

  const uint32_t hi_a = smem_addr(hs), lo_a = smem_addr(ls);
  const auto bias = [half_e2](int col) { return half_e2[col]; };
  double acc = 0.0;
  float d[128];
  int buf = 0;
#pragma unroll 1
  for (; tile < tiles; tile += stride, buf ^= 1) {
    const long long row0 = tile * TILE_ROWS + wrow;
    if (tile + stride < tiles)
      load_rows(xs + (buf ^ 1) * X_TILE, x, row0 + stride * TILE_ROWS, n, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's rows are in
    __syncwarp();
    const float* xb = xs + buf * X_TILE;
    uint32_t ah[K_STEPS][4], al[K_STEPS][4];
    load_a<DIST>(xb, lane, ah, al);
    mlm::Best best[2] = {{-CUDART_INF_F, 0.f, mlm::NO_INDEX},
                         {-CUDART_INF_F, 0.f, mlm::NO_INDEX}};
#pragma unroll 1
    for (int n0 = 0; n0 < kpad; n0 += BN) {
      products<DIST>(d, ah, al, hi_a + n0 * ROW_BYTES, lo_a + n0 * ROW_BYTES);
      mlm::fold_tile<false>(d, best, n0 + 2 * t, bias);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {  // the quad's 4 lanes hold the same rows
        mlm::Best other;
        other.m = __shfl_xor_sync(FULL, best[r].m, o);
        other.idx = __shfl_xor_sync(FULL, best[r].idx, o);
        mlm::combine(best[r], other, false);
      }
    // row L of the warp's 16, in lane L: row g is quad g's best[0], row g + 8 its best[1]
    const int c0 = __shfl_sync(FULL, best[0].idx, 4 * (lane & 7));
    const int c1 = __shfl_sync(FULL, best[1].idx, 4 * (lane & 7));
    const int code = lane & 8 ? c1 : c0;
    const bool valid = lane < WARP_ROWS && row0 + lane < n;
    if (valid) idx[row0 + lane] = code;
    vq_common::count(hist, code, valid, lane);
    acc += store_rows<QUANT>(q, cb, hs, ls, xb, row0, n, code, lane);
    __syncwarp();  // the tile is read: the next iteration's copy may overwrite it
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

template <int DIST, int QUANT>
int launch_fwd(const float* x, const float* cb, const uint4* cbh, const uint4* cbl,
               const float* e2, float* q, int* idx, float* counts, float* sq, int* counts_i,
               double* sq_part, int max_parts, long long n, int k_codes, cudaStream_t s) {
  const size_t smem = fwd_smem_bytes(k_codes, DIST == DIST_SPLIT3 || QUANT == QUANT_SPLIT2);
  const long long blocks = ((n + TILE_ROWS - 1) / TILE_ROWS + GROUPS - 1) / GROUPS;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_precision_fwd_kernel<DIST, QUANT>, smem, counts_i,
                                   k_codes, blocks, max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_precision_fwd_kernel<DIST, QUANT><<<grid, THREADS, smem, s>>>(
        x, cb, cbh, cbl, e2, q, idx, counts_i, sq_part, n, k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

}  // namespace

// dist: 0 bf16, 1 split3; quant: 0 f32, 1 split2 (the three pairs the
// measurement tool runs besides f32/f32). x (n, D) and cb (K, D) fp32, cbh and
// cbl (K, D) bf16, e2 (K,) the |e|^2 of the dotted codebook. q (n, D), idx
// (n,), counts (K,), sq () are the outputs; counts_i (K,) int and sq_part
// (max_parts,) double are scratch; cbh and cbl 16-byte aligned. The wrapper
// checks that K is a multiple of 64 and that fwd_smem_bytes fit
// (ops/vq_precision.py check_codes).
extern "C" int vq_precision_fwd(int dist, int quant, const float* x, const float* cb,
                                const void* cbh, const void* cbl, const float* e2, float* q,
                                int* idx, float* counts, float* sq, int* counts_i,
                                double* sq_part, int max_parts, long long n, int k_codes,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint4* h = static_cast<const uint4*>(cbh);
  const uint4* l = static_cast<const uint4*>(cbl);
  if (dist == DIST_BF16 && quant == QUANT_SPLIT2)
    return launch_fwd<DIST_BF16, QUANT_SPLIT2>(x, cb, h, l, e2, q, idx, counts, sq, counts_i,
                                               sq_part, max_parts, n, k_codes, s);
  if (dist == DIST_BF16 && quant == QUANT_F32)
    return launch_fwd<DIST_BF16, QUANT_F32>(x, cb, h, l, e2, q, idx, counts, sq, counts_i,
                                            sq_part, max_parts, n, k_codes, s);
  if (dist == DIST_SPLIT3 && quant == QUANT_SPLIT2)
    return launch_fwd<DIST_SPLIT3, QUANT_SPLIT2>(x, cb, h, l, e2, q, idx, counts, sq, counts_i,
                                                 sq_part, max_parts, n, k_codes, s);
  return (int)cudaErrorInvalidValue;
}

// The most clusters of the split2 gradient kernel at K codes that run at once.
extern "C" int vq_precision_bwd_split2_clusters(int k_codes, int* clusters) {
  return segsum::max_clusters<true>(k_codes, clusters);
}

// g (n, D) fp32 and idx (n,) int32, both 16-byte aligned; dcb (K, D) is the
// output; partials (clusters, 2, K, D) is scratch; blocks 2p and 2p + 1 of the
// clusters * 4 take the rows [p * rows_per_part, ...), a multiple of 128, and
// the columns of one half each. The wrapper checks that ops/vq_precision.py
// bwd_smem_bytes(K) fit (K <= 689).
extern "C" int vq_precision_bwd_split2(const float* g, const int* idx, float* dcb,
                                       float* partials, int clusters, long long rows_per_part,
                                       long long n, int k_codes, void* stream) {
  return segsum::launch<true>(g, idx, dcb, partials, clusters, rows_per_part, n, k_codes,
                              (cudaStream_t)stream);
}
