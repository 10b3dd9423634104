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
// Forward design: persistent blocks of 8 warps, each block with cb_hi (and,
// for split3, cb_lo) and the |e|^2 of the dotted codebook in shared memory,
// rows padded to 72 bf16 so that a B-fragment load (8 codes x 4 lanes) hits 32
// banks. A warp takes 16 rows: it loads them once as fp32 (kept for the
// squared error), rounds them to bf16 with __float2bfloat16_rn (the RNE of
// JAX's astype; split3 also xl = bf16(x - xh)) straight into
// mma.sync.m16n8k16 A fragments, and walks the codebook in chunks of 64 codes
// (8 n-tiles, D = 64 is 4 k-steps), fp32 accumulators. Split3 accumulates its
// two small products first, then xh.cbh, in one accumulator. Each lane keeps
// a running (min, argmin) of its two rows over its codes in ascending order,
// strict <; the four lanes of a quad then combine by "smaller, or equal and
// lower index": the first minimum, as the TPU's `dist <= m` then min-lane.
// q is a gather of the chosen row (split2: float(cb_hi) + float(cb_lo), the
// bits of the TPU's one-hot products), written by the lanes that hold the
// row's x, so the exact (q - x)^2 sum needs no second read of x. Counts and
// the sum are deterministic (vq_common.cuh). No wgmma and no TMA.
//
// Gradient design: vq_fused.cu's codebook gradient with two accumulators.
// Two (K, D) fp32 sums do not fit in one block's shared memory, so each block
// owns half of the columns: (K, 32) for the hi sum and (K, 32) for the lo
// sum. Its 8 warps own 4 columns each, lanes map to rows, the split is made
// in registers (no gl array in device memory), lanes with one code are
// grouped with __match_any_sync and summed in lane order. Blocks write their
// hi and lo partials apart; a second kernel sums each in block order and adds
// the two at the end. Deterministic.
#include <cuda_bf16.h>
#include <stdint.h>

#include "vq_common.cuh"

namespace {

using vq_common::add4;
using vq_common::FULL;

constexpr int D = 64;
constexpr int DIST_BF16 = 0, DIST_SPLIT3 = 1;   // the wrapper's codes
constexpr int QUANT_F32 = 0, QUANT_SPLIT2 = 1;

// ---- forward ------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_BLOCK = 16 * WARPS;  // one m16 tile of rows per warp
constexpr int CB_WORDS = (D + 8) / 2;       // 32-bit words per padded bf16 codebook row
constexpr int N_TILES = 8;                  // 8 codes each: 64 codes a chunk

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

// c += a . b over one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void keep_min(float d, int code, float& best, int& arg) {
  if (d < best) {
    best = d;
    arg = code;
  }
}

template <int DIST, int QUANT>
__global__ void __launch_bounds__(THREADS, 1)
vq_precision_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                        const uint32_t* __restrict__ cbh, const uint32_t* __restrict__ cbl,
                        const float* __restrict__ e2, float* __restrict__ q,
                        int* __restrict__ idx, int* __restrict__ counts_i,
                        double* __restrict__ sq_part, long long n, int k_codes) {
  extern __shared__ uint32_t smem_words[];
  uint32_t* hs = smem_words;                                           // [K][CB_WORDS] cb_hi
  uint32_t* ls = hs + (size_t)k_codes * CB_WORDS;                      // [K][CB_WORDS] cb_lo
  float* e2s = reinterpret_cast<float*>(DIST == DIST_SPLIT3 ? ls + (size_t)k_codes * CB_WORDS
                                                            : ls);     // [K]
  int* hist = reinterpret_cast<int*>(e2s + k_codes);                   // [K]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and thread-in-group
  for (int i = tid; i < k_codes * (D / 2); i += THREADS) {
    const int r = i / (D / 2), w = i % (D / 2);
    hs[r * CB_WORDS + w] = cbh[i];
    if (DIST == DIST_SPLIT3) ls[r * CB_WORDS + w] = cbl[i];
  }
  for (int i = tid; i < k_codes; i += THREADS) {
    e2s[i] = e2[i];
    hist[i] = 0;
  }
  __syncthreads();

  double acc = 0.0;
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    // this lane's rows g and g + 8 of the warp's 16, at columns 16s + 8h + 2t (+1)
    const long long rows[2] = {blk * ROWS_PER_BLOCK + warp * 16 + g,
                               blk * ROWS_PER_BLOCK + warp * 16 + g + 8};
    const bool valid[2] = {rows[0] < n, rows[1] < n};
    float2 xv[2][4][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xv[r][s][h] = valid[r] ? *reinterpret_cast<const float2*>(
                                       x + rows[r] * D + 16 * s + 8 * h + 2 * t)
                                 : make_float2(0.0f, 0.0f);
    uint32_t ah[4][4], al[4][4];  // A fragments of x_hi and x_lo, per k-step
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0: (g, lo cols), a1: (g+8, lo), a2: (g, hi), a3: (g+8, hi)
        const float2 v = xv[i & 1][s][i >> 1];
        ah[s][i] = pack(v.x, v.y);
        if (DIST == DIST_SPLIT3) al[s][i] = pack_lo(v.x, v.y);
      }

    float best[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
    int arg[2] = {0, 0};
    for (int c0 = 0; c0 < k_codes; c0 += 8 * N_TILES) {
      float d[N_TILES][4];
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
        const uint32_t* hrow = hs + (c0 + 8 * j + g) * CB_WORDS + t;
        if (DIST == DIST_SPLIT3) {
          const uint32_t* lrow = ls + (c0 + 8 * j + g) * CB_WORDS + t;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            mma(d[j], al[s], hrow[8 * s], hrow[8 * s + 4]);
            mma(d[j], ah[s], lrow[8 * s], lrow[8 * s + 4]);
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) mma(d[j], ah[s], hrow[8 * s], hrow[8 * s + 4]);
      }
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {  // codes c, c + 1 of rows g (d0, d1), g + 8 (d2, d3)
        const int c = c0 + 8 * j + 2 * t;
        const float2 e = *reinterpret_cast<const float2*>(e2s + c);
        keep_min(e.x - 2.0f * d[j][0], c, best[0], arg[0]);
        keep_min(e.y - 2.0f * d[j][1], c + 1, best[0], arg[0]);
        keep_min(e.x - 2.0f * d[j][2], c, best[1], arg[1]);
        keep_min(e.y - 2.0f * d[j][3], c + 1, best[1], arg[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(FULL, best[r], off);
        const int oa = __shfl_xor_sync(FULL, arg[r], off);
        if (ob < best[r] || (ob == best[r] && oa < arg[r])) {
          best[r] = ob;
          arg[r] = oa;
        }
      }

    vq_common::count(hist, arg[0], valid[0] && t == 0, lane);
    vq_common::count(hist, arg[1], valid[1] && t == 0, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      if (t == 0) idx[rows[r]] = arg[r];
      float sq = 0.0f;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 16 * s + 8 * h + 2 * t;
          float2 qv;
          if (QUANT == QUANT_F32) {
            qv = *reinterpret_cast<const float2*>(cb + arg[r] * D + col);
          } else {
            const float2 hi = unpack(cbh[(arg[r] * D + col) / 2]);
            const float2 lo = unpack(cbl[(arg[r] * D + col) / 2]);
            qv = make_float2(hi.x + lo.x, hi.y + lo.y);
          }
          *reinterpret_cast<float2*>(q + rows[r] * D + col) = qv;
          const float dx = qv.x - xv[r][s][h].x, dy = qv.y - xv[r][s][h].y;
          sq = fmaf(dx, dx, sq);
          sq = fmaf(dy, dy, sq);
        }
      acc += (double)sq;
    }
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

template <int DIST, int QUANT>
int launch_fwd(const float* x, const float* cb, const uint32_t* cbh, const uint32_t* cbl,
               const float* e2, float* q, int* idx, float* counts, float* sq, int* counts_i,
               double* sq_part, int max_parts, long long n, int k_codes, cudaStream_t s) {
  const int arrays = DIST == DIST_SPLIT3 ? 2 : 1;
  const size_t smem = (size_t)k_codes * (arrays * CB_WORDS * 4 + 8);
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_precision_fwd_kernel<DIST, QUANT>, smem, counts_i,
                                   k_codes, blocks, max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_precision_fwd_kernel<DIST, QUANT><<<grid, THREADS, smem, s>>>(
        x, cb, cbh, cbl, e2, q, idx, counts_i, sq_part, n, k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

// ---- codebook gradient, split2 --------------------------------------------------

constexpr int GRAD_THREADS = 256;                  // 8 warps
constexpr int HALF = D / 2;                        // columns a block owns
constexpr int COLS = HALF / (GRAD_THREADS / 32);   // columns a warp owns: 4
constexpr int ACC_STRIDE = HALF + 4;               // padded rows, as in vq_fused.cu

struct RowSlice {
  int code;   // -1 past the block's rows
  float4 v;   // the warp's 4 columns of the row
};

__device__ __forceinline__ RowSlice fetch(const float* __restrict__ g,
                                          const int* __restrict__ idx, long long row,
                                          long long end, int col) {
  RowSlice s{-1, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (row < end) {
    s.code = idx[row];
    s.v = *reinterpret_cast<const float4*>(g + row * D + col);
  }
  return s;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Block 2p + h takes the rows of part p and the columns of half h. partials
// is [2][parts][K][D]: the hi sums, then the lo sums.
__global__ void __launch_bounds__(GRAD_THREADS, 1)
vq_grad_split2_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                      float* __restrict__ partials, int parts, long long n, int k_codes,
                      long long rows_per_part) {
  extern __shared__ float smem[];
  float* acc_hi = smem;                                      // [K][ACC_STRIDE]
  float* acc_lo = acc_hi + (size_t)k_codes * ACC_STRIDE;     // [K][ACC_STRIDE]
  float4* stage = reinterpret_cast<float4*>(acc_lo + (size_t)k_codes * ACC_STRIDE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x >> 1, half = blockIdx.x & 1;
  for (int i = tid; i < 2 * k_codes * ACC_STRIDE; i += GRAD_THREADS) acc_hi[i] = 0.0f;
  __syncthreads();
  float4* st = stage + warp * 64;  // [2][32]: hi then lo of each lane's row
  const int col = half * HALF + COLS * warp;

  const long long begin = (long long)part * rows_per_part;
  const long long end = begin + rows_per_part < n ? begin + rows_per_part : n;
  RowSlice cur = fetch(g, idx, begin + lane, end, col);
  for (long long r0 = begin; r0 < end; r0 += 32) {
    const RowSlice next = fetch(g, idx, r0 + 32 + lane, end, col);  // in flight meanwhile
    const float4 hi = make_float4(bf16_round(cur.v.x), bf16_round(cur.v.y),
                                  bf16_round(cur.v.z), bf16_round(cur.v.w));
    st[lane] = hi;
    st[32 + lane] = make_float4(bf16_round(cur.v.x - hi.x), bf16_round(cur.v.y - hi.y),
                                bf16_round(cur.v.z - hi.z), bf16_round(cur.v.w - hi.w));
    const bool valid = (unsigned)cur.code < (unsigned)k_codes;
    const unsigned peers = __match_any_sync(FULL, valid ? cur.code : -1);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) {
      float4 sh = make_float4(0.f, 0.f, 0.f, 0.f), sl = sh;
      for (unsigned m = peers; m; m &= m - 1) {  // ascending lanes: a fixed order
        const int j = __ffs(m) - 1;
        add4(sh, st[j]);
        add4(sl, st[32 + j]);
      }
      const size_t o = (size_t)cur.code * ACC_STRIDE + COLS * warp;
      add4(*reinterpret_cast<float4*>(acc_hi + o), sh);
      add4(*reinterpret_cast<float4*>(acc_lo + o), sl);
    }
    __syncwarp();
    cur = next;
  }
  __syncthreads();

  const size_t lo_offset = (size_t)parts * k_codes * D;
  for (int i = tid; i < k_codes * HALF; i += GRAD_THREADS) {
    const int r = i / HALF, c = i % HALF;
    const size_t o = ((size_t)part * k_codes + r) * D + half * HALF + c;
    partials[o] = acc_hi[r * ACC_STRIDE + c];
    partials[lo_offset + o] = acc_lo[r * ACC_STRIDE + c];
  }
}

}  // namespace

// dist: 0 bf16, 1 split3; quant: 0 f32, 1 split2 (the three pairs the
// measurement tool runs besides f32/f32). x (n, D) and cb (K, D) fp32, cbh and
// cbl (K, D) bf16, e2 (K,) the |e|^2 of the dotted codebook. q (n, D), idx
// (n,), counts (K,), sq () are the outputs; counts_i (K,) int and sq_part
// (max_parts,) double are scratch. The wrapper checks that K is a multiple of
// 64 and that the codebook fits in shared memory.
extern "C" int vq_precision_fwd(int dist, int quant, const float* x, const float* cb,
                                const void* cbh, const void* cbl, const float* e2, float* q,
                                int* idx, float* counts, float* sq, int* counts_i,
                                double* sq_part, int max_parts, long long n, int k_codes,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* h = static_cast<const uint32_t*>(cbh);
  const uint32_t* l = static_cast<const uint32_t*>(cbl);
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

// dcb (K, D) is the output; partials (2, max_parts, K, D) is scratch. The
// wrapper checks that 2*K*(D/2+4)*4 + 8 KB bytes fit in shared memory.
extern "C" int vq_precision_bwd_split2(const float* g, const int* idx, float* dcb,
                                       float* partials, int max_parts, long long n,
                                       int k_codes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = 2 * (size_t)k_codes * ACC_STRIDE * sizeof(float) +
                      (GRAD_THREADS / 32) * 64 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      vq_grad_split2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (int e = vq_common::sm_count(&sms)) return e;
  long long parts = (n + 31) / 32;  // at least 32 rows a part; two blocks a part
  if (parts > sms / 2) parts = sms / 2 > 0 ? sms / 2 : 1;
  if (parts > max_parts) parts = max_parts;
  if (parts > 0) {
    long long rows = (n + parts - 1) / parts;
    rows = (rows + 31) / 32 * 32;
    vq_grad_split2_kernel<<<2 * (int)parts, GRAD_THREADS, smem, s>>>(g, idx, partials,
                                                                     (int)parts, n, k_codes,
                                                                     rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int kd = k_codes * D;
  vq_common::grad_reduce_kernel<<<(kd + 255) / 256, 256, 0, s>>>(partials, (int)parts, kd, 2,
                                                                 dcb);
  return (int)cudaGetLastError();
}
