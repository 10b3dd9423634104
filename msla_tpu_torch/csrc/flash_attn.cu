// Flash attention with a key-padding mask, on fp32 q, k, v or, for the bf16
// compute_dtype, bf16 ones; fp32 statistics and an fp32 output either way:
//   out = softmax(q . k^T * sm_scale + (1 - mask) * -1e9) . v
// per (sequence, head), without the (S, S) scores ever reaching device memory.
//
// Replaces: msla_tpu/ops/flash_attn.py:51 _flash (JAX's bundled TPU flash
// attention, jax.experimental.pallas.ops.tpu.flash_attention) at head width
// 64; csrc/flash_any.cu takes every other width up to 256, and
// csrc/flash_bwd.cu the backward at every width.
//
// Sq query rows and Sk keys, each >= 1 and free of each other: the key loop
// and the mask row run over Sk, the query rows and the store over Sq. Under
// autograd the wrapper passes a non-null `lse`, (B, H, Sq) fp32, and `shift`,
// each sequence's largest bias (null: 0): the kernel writes each query row's
// log-sum-exp less it, (m - shift) + log(l), for the backward to recompute P
// from. In blocks that take the one-FFMA exponent (below), l carries the
// common factor 2^(m log2(e) - ml), within 2^-24 |m| of 1 in its log; the
// backward's bound (chip_smoke.py attention_grad_bound) holds that.
//
// Bound on an H100: one BERT layer of the batch-16 Audio-BERT call has 352
// sequences x 12 heads x 512 tokens x 64 dims; Q K^T and P V are 4*B*H*S*S*D =
// 2.83e11 FLOP.
// - bf16: q, k, v are 277 MB each (831 MB) and the fp32 output 554 MB, 1.385
//   GB in all: 0.413 ms at 3.35 TB/s, against 0.29 ms for the FLOP at the
//   bf16 tensor-core peak (989 TFLOP/s). Bound by bytes: 0.413 ms.
// - fp32 on the tensor cores, held (as #6 fp32 is) to its FLOP at the TF32
//   peak (495 TFLOP/s): 0.57 ms, against 2.22 GB at 3.35 TB/s = 0.66 ms.
//   Bound by bytes: 0.66 ms. The 3xTF32 design runs three products, 1.72 ms
//   at the TF32 peak; the same FLOP on the fp32 FMA units take 4.23 ms.
//
// Design (FA2 on mma.sync): a block of 4 warps takes the query rows of one
// (sequence, head), each warp MT m-tiles of 16 rows (bf16: 2, a block 128
// rows; fp32: 1, a block 64 rows, its split Q fragments leave no registers for
// a second). The Q tile is loaded once; K and V come in tiles of 64 keys
// through a two-stage cp.async ring, so the next tile's loads run under this
// tile's products, with one barrier a tile. Q K^T and P V run on the tensor
// cores with fp32 accumulators; the online softmax stays in registers: each
// row's running max m and sum l, and the output accumulator rescaled by
// exp(m_old - m_new). A row's scores sit in the four threads of a quad (the
// m16n8 C layout), so row maxima and sums are two __shfl_xor_sync steps after
// a fixed tree over the thread's 16 values: the result has the same bits run
// after run. exp is ex2.approx (~2^-22 of p) of one FFMA, s log2(e) - m
// log2(e) (m log2(e) rounded: FA2's form), in blocks whose sequence's key 0
// is no padding, and of (s - m) log2(e) in the others (see the kernel).
// - A power-of-two sm_scale (1/8 for 64-wide heads) is folded into Q's
//   fragments when they are loaded: q * 2^e is exact (short of underflow), so
//   every partial sum of the products, and the score, is the unscaled one
//   times 2^e bit for bit, and no multiply is left per score. A warp whose
//   key tile lies inside the sequence with every mask value 1 adds no bias
//   (a bias of -0 changes nothing); it learns that from one vote.
// - Each K or V fragment feeds the warp's MT m-tiles, and K/V tiles are read
//   by S / 128 blocks of a head in bf16 (S / 64 in fp32) through L2.
// - bf16: mma.sync.m16n8k16 bf16 x bf16 -> fp32. Fragments come from shared
//   memory by ldmatrix (.trans for V); rows are padded to 72 values (144 B),
//   so the 8 rows of each 8x8 matrix hit distinct banks. P never touches
//   shared memory: the S accumulator's m16n8 C layout, rounded to bf16
//   pairs, is the A fragment of P V. Products of bf16 values are exact in
//   fp32, so only the order of the fp32 sums differs from the plain version.
// - fp32: 3xTF32 on mma.sync.m16n8k8 tf32 -> fp32: each operand x is split as
//   hi = tf32(x), lo = tf32(x - hi) (cvt.rna.tf32.f32's rounding, as #6 fp32
//   rounds, mlm_argmax.cu), and each k8 step adds lo.hi, hi.lo, then hi.hi
//   into one accumulator. q is split once as its fragments are loaded, k and
//   v as theirs are, and P in registers. Plain single-pass TF32 would lose
//   ~11 bits of each product. The m16n8 C layout gives a thread P's columns
//   2t and 2t+1, while tf32's m16n8k8 A fragment wants columns t and t+4. A
//   sum over keys does not care about their order, so the kernel lets A's
//   column t be key 2t and column t+4 be key 2t+1, and each B fragment reads
//   V's rows 2t and 2t+1 to match: P stays in registers and needs no
//   shuffle or shared-memory staging (rows padded to 68 floats: those reads
//   hit 32 banks). Per key tile a warp then runs 384 tensor-core products.
// What binds it (PERF.md section 7): neither product nor the softmax alone;
// a warp runs Q K^T, softmax and P V in turn, and 8 warps an SM (the
// registers of two m-tiles allow no more) overlap them only in part. Per
// score it spends what FA2 spends (a max, an FFMA, an ex2, an add). A
// pipeline that issued tile t + 1's Q K^T before tile t's softmax needed the
// registers of a second score tile and lost more to occupancy than it won;
// overlapping them takes asynchronous products (wgmma), the next design.
//
// The mask is added as the plain version adds it: s * sm_scale, rounded, plus
// (1 - mask) * -1e9, rounded (no FMA contraction). A sequence whose keys are
// all padding then has every score equal to -1e9 in fp32 (for |s| < 32) and
// its softmax is uniform: its output is the mean of v, as in the plain
// version, not 0/0. Keys past Sk (Sk not a multiple of 64) carry -inf and no
// weight; query rows past Sq are computed on zero rows and never stored. q, k,
// v and out are read and written in the projections' (B, S, H, D) layout, so
// no transpose is needed on either side.
//
// bf16 (JAX's TPU kernel on bf16 q, k, v): the scores are fp32 sums of exact
// products and the statistics fp32; each p = exp(s - m) is rounded to bf16 for
// P . V (the kernel's p.astype(v.dtype)) while the row sum l takes it
// unrounded, and the output stays fp32. The plain version rounds the
// normalised probabilities instead, so the two part by up to 2^-8 of
// sum_k p_k |v_k|.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int D = 64;        // head dim the kernel is compiled for
constexpr int BK = 64;       // keys per tile
constexpr int NT = BK / 8;   // n8 tiles of keys
constexpr int STAGES = 2;    // K/V tiles in the cp.async ring
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// Per operand type: the padded shared row (elements), the m-tiles of 16 query
// rows a warp takes, and the shared memory (bytes) of a stage (the K tile,
// the V tile, the mask values) and of the block (the Q tile and the ring).
// Two blocks of 4 warps an SM.
template <typename T, int LD_, int MT_>
struct LayoutOf {
  static constexpr int LD = LD_;
  static constexpr int MT = MT_;
  static constexpr int BQ = 16 * MT * WARPS;  // query rows per block
  static constexpr int STAGE_BYTES = 2 * BK * LD * (int)sizeof(T) + BK * (int)sizeof(float);
  static constexpr int SMEM_BYTES = BQ * LD * (int)sizeof(T) + STAGES * STAGE_BYTES;
};
template <typename T>
struct Layout;
template <>
struct Layout<__nv_bfloat16> : LayoutOf<__nv_bfloat16, D + 8, 2> {};  // 144-byte rows
template <>
struct Layout<float> : LayoutOf<float, D + 4, 1> {};                  // 272-byte rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of one head from a (B, S, H, D) tensor into a
// padded (ROWS, LD) shared tile; rows at or past seq_len are zero.
template <int ROWS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0,
                                          int seq_len, long long row_stride) {
  constexpr int PER = 16 / (int)sizeof(T);   // values per 16-byte chunk
  constexpr int CHUNKS = D / PER;            // chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool valid = row0 + r < seq_len;
    cp_async16(dst + r * Layout<T>::LD + c * PER,
               src + (long long)(valid ? row0 + r : 0) * row_stride + c * PER, valid);
  }
}

// ---- the products, per operand type ------------------------------------------
// s[n][0..3]: the m16n8 C layout of key tile n (keys 8n..8n+7 of the tile):
// rows g (c0, c1) and g + 8 (c2, c3) of the warp's 16, keys 8n + 2t, 8n + 2t + 1,
// with g = lane / 4, t = lane % 4. o[e][0..3] likewise for columns 8e.. of out.

// c += a . b over one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a . b over one m16n8k16 tile, from zero accumulators.
__device__ __forceinline__ void mma_bf16_first(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Two fp32 values as a bf16x2 word, a in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// The warp's MT m-tiles of 16 query rows: Q K^T into s, P V into o.
template <typename T, int MT>
struct Products;

template <int MT>
struct Products<__nv_bfloat16, MT> {
  using T = __nv_bfloat16;
  static constexpr int LD = Layout<T>::LD;
  uint32_t qf[MT][4][4];  // A fragments of Q, one per m-tile and k16 step

  // scale: 1, or sm_scale when it is a power of two (then exact, see the kernel)
  __device__ __forceinline__ void load_q(const T* qs, int warp, int lane, float scale) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ldsm_x4(qf[i][j], qs + (16 * (MT * warp + i) + (lane & 15)) * LD + 16 * j +
                              (lane >> 4) * 8);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = unpack_bf16(qf[i][j][c]);
          qf[i][j][c] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
  }

  __device__ __forceinline__ void scores(float (&s)[MT][NT][4], const T* ks, int lane) const {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {  // key tiles 2p, 2p + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * p + (lane & 7) + (lane >> 4) * 8) * LD + 16 * j +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (j == 0) {
            mma_bf16_first(s[i][2 * p], qf[i][j], b[0], b[1]);
            mma_bf16_first(s[i][2 * p + 1], qf[i][j], b[2], b[3]);
          } else {
            mma_bf16(s[i][2 * p], qf[i][j], b[0], b[1]);
            mma_bf16(s[i][2 * p + 1], qf[i][j], b[2], b[3]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void accumulate(float (&o)[MT][8][4], const float (&p)[MT][NT][4],
                                             const T* vs, int lane) const {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {  // keys 16j .. 16j + 15: key tiles 2j, 2j + 1
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a[i][0] = pack_bf16(p[i][2 * j][0], p[i][2 * j][1]);
        a[i][1] = pack_bf16(p[i][2 * j][2], p[i][2 * j][3]);
        a[i][2] = pack_bf16(p[i][2 * j + 1][0], p[i][2 * j + 1][1]);
        a[i][3] = pack_bf16(p[i][2 * j + 1][2], p[i][2 * j + 1][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // output columns 16e .. 16e + 15
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 16 * e +
                             (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(o[i][2 * e], a[i], b[0], b[1]);
          mma_bf16(o[i][2 * e + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
};

template <int MT>
struct Products<float, MT> {
  using T = float;
  static constexpr int LD = Layout<T>::LD;
  uint32_t qh[MT][8][4], ql[MT][8][4];  // A fragments of Q, split, one per k8 step

  __device__ __forceinline__ void load_q(const T* qs, int warp, int lane, float scale) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t r[4];
        ldsm_x4(r, qs + (16 * (MT * warp + i) + (lane & 15)) * LD + 8 * j + (lane >> 4) * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split(__float_as_uint(__uint_as_float(r[c]) * scale), qh[i][j][c], ql[i][j][c]);
      }
  }

  __device__ __forceinline__ void scores(float (&s)[MT][NT][4], const T* ks, int lane) const {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {  // k8 steps j, j + 1: d 8j .. 8j + 15
        uint32_t b[4], bh[4], bl[4];
        ldsm_x4(b, ks + (8 * n + (lane & 7)) * LD + 8 * j + (lane >> 3) * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) split(b[c], bh[c], bl[c]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_3xtf32(s[i][n], qh[i][j], ql[i][j], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[i][n], qh[i][j + 1], ql[i][j + 1], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void accumulate(float (&o)[MT][8][4], const float (&p)[MT][NT][4],
                                             const T* vs, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // key tile j: A column t is key 2t, column t + 4 key 2t + 1
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float a[4] = {p[i][j][0], p[i][j][2], p[i][j][1], p[i][j][3]};
#pragma unroll
        for (int c = 0; c < 4; ++c) split(__float_as_uint(a[c]), ah[i][c], al[i][c]);
      }
      const T* v0 = vs + (8 * j + 2 * t) * LD + g;  // V rows 2t, 2t + 1 of the key tile
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        uint32_t bh0, bl0, bh1, bl1;
        split(__float_as_uint(v0[8 * e]), bh0, bl0);
        split(__float_as_uint(v0[LD + 8 * e]), bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_3xtf32(o[i][e], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
  }
};

// The largest (sum) of a thread's 16 values of one row: a tree, in a fixed order.
__device__ __forceinline__ float row_max(const float (&s)[NT][4], int r) {
  float v[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) v[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
  for (int w = NT / 2; w > 0; w >>= 1)
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] = fmaxf(v[n], v[n + w]);
  return v[0];
}

__device__ __forceinline__ float row_sum(const float (&s)[NT][4], int r) {
  float v[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) v[n] = s[n][2 * r] + s[n][2 * r + 1];
#pragma unroll
  for (int w = NT / 2; w > 0; w >>= 1)
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] += v[n + w];
  return v[0];
}

// One block's work. KEY0: its sequence's key 0 is not padding, so every
// row's running max is a real score from the first tile on (see the kernel).
template <typename T, bool KEY0>
__device__ __forceinline__ void attend(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const float* __restrict__ mask,
                                       const float* __restrict__ shift, float* __restrict__ out,
                                       float* __restrict__ lse, int n_heads, int s_q, int s_k,
                                       float sm_scale) {
  constexpr int LD = Layout<T>::LD;
  constexpr int BQ = Layout<T>::BQ;
  constexpr int MT = Layout<T>::MT;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* qs = reinterpret_cast<T*>(smem);
  auto ks = [&](int st) {
    return reinterpret_cast<T*>(smem + BQ * LD * sizeof(T) + st * Layout<T>::STAGE_BYTES);
  };
  auto vs = [&](int st) { return ks(st) + BK * LD; };
  auto ms = [&](int st) { return reinterpret_cast<float*>(vs(st) + BK * LD); };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)n_heads * D;
  const long long base = (long long)b * s_q * row_stride + (long long)h * D;    // q, out
  const long long kv_base = (long long)b * s_k * row_stride + (long long)h * D; // k, v
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (s_k + BK - 1) / BK;
  const float* mrow = mask ? mask + (long long)b * s_k : nullptr;
  // A power-of-two sm_scale (1/8 for 64-wide heads) is folded into Q's
  // fragments: q * 2^e is exact, so every partial sum of the products is the
  // unscaled one times 2^e, bit for bit, and the scores come out as
  // s * sm_scale rounded without a multiply.
  const bool pow2 = sm_scale > 0.f && sm_scale < CUDART_INF_F &&
                    (__float_as_uint(sm_scale) & 0x7fffffu) == 0u;
  const float score_scale = pow2 ? 1.f : sm_scale;

  auto load_tile = [&](int tile) {  // K, V and mask of key tile `tile` into its stage
    const int st = tile % STAGES, k0 = tile * BK;
    load_rows<BK>(ks(st), k + kv_base, k0, s_k, row_stride);
    load_rows<BK>(vs(st), v + kv_base, k0, s_k, row_stride);
    for (int i = threadIdx.x; mrow && i < BK; i += THREADS) {
      const int key = k0 + i;
      cp_async4(ms(st) + i, mrow + (key < s_k ? key : 0), key < s_k);
    }
  };

  // group 0: Q and key tile 0; then one group per tile (empty past the end)
  load_rows<BQ>(qs, q + base, q0, s_q, row_stride);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  Products<T, MT> prod;
  float o[MT][8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = -CUDART_INF_F;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][e][c] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile landed for every thread; tile - 1's stage is free
    if (tile + STAGES - 1 < n_tiles) load_tile(tile + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tile == 0) prod.load_q(qs, warp, lane, pow2 ? sm_scale : 1.f);

    const int st = tile % STAGES, k0 = tile * BK;
    float s[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][n][c] = 0.f;
    prod.scores(s, ks(st), lane);

    // scores: s * sm_scale, rounded, + bias, rounded; -inf past the end. A
    // mask of 1 gives a bias of -0, whose add changes nothing: a warp whose
    // tile lies inside the sequence with every mask value 1 skips the adds.
    bool ones = true;
    if (mrow) {
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) ones = ones && ms(st)[32 * c + lane] == 1.f;
    }
    if (__all_sync(0xffffffffu, ones) && k0 + BK <= s_k) {
      if (!pow2) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[i][n][c] = __fmul_rn(s[i][n][c], score_scale);
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t + c;
          float bias = mrow ? __fmul_rn(1.f - ms(st)[col], -1e9f) : 0.f;
          if (k0 + col >= s_k) bias = -CUDART_INF_F;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              s[i][n][2 * r + c] = __fadd_rn(__fmul_rn(s[i][n][2 * r + c], score_scale), bias);
        }
    }

    // online softmax, per row: key 0 of the first tile is in range, so m is finite
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = row_max(s[i], r);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i][r], mx);
        float alpha;  // 0 on the first tile
        if constexpr (KEY0) {  // p = 2^(s log2(e) - ml), ml = m log2(e) rounded: one FFMA
          const float ml = __fmul_rn(m_new, LOG2E);
          alpha = ex2(__fmul_rn(m[i][r], LOG2E) - ml);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              s[i][n][2 * r + c] = ex2(fmaf(s[i][n][2 * r + c], LOG2E, -ml));
        } else {  // p = 2^((s - m) log2(e)): 1 where s = m, as for all-padding keys
          alpha = ex2((m[i][r] - m_new) * LOG2E);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              s[i][n][2 * r + c] = ex2((s[i][n][2 * r + c] - m_new) * LOG2E);
        }
        m[i][r] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[i][e][2 * r] *= alpha;
          o[i][e][2 * r + 1] *= alpha;
        }
        l[i][r] = l[i][r] * alpha + row_sum(s[i], r);  // this thread's keys
      }
    prod.accumulate(o, s, vs(st), lane);
  }

  // the quad's partial sums, in a fixed order; then the fp32 output and,
  // under autograd, the row's log-sum-exp less the sequence's shift
  const float c = shift ? shift[b] : 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[i][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const int row = q0 + 16 * (MT * warp + i) + g + 8 * r;
      if (lse && row < s_q && t == 0)
        lse[((long long)b * n_heads + h) * s_q + row] = __fadd_rn(m[i][r] - c, logf(sum));
      if (row < s_q) {
        float* dst = out + base + (long long)row * row_stride + 2 * t;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          *reinterpret_cast<float2*>(dst + 8 * e) =
              make_float2(o[i][e][2 * r] * inv, o[i][e][2 * r + 1] * inv);
      }
    }
}

// A block whose sequence's key 0 is not padding (no mask, or mask 1 there)
// takes the exponent in one FFMA: every row's max is then a real score from
// the first tile on, and p = 2^(s log2(e) - ml) is exp(s - m) times
// 2^(m log2(e) - ml), within 2^-20 or so of 1 and shared by o and l, whose
// ratio cancels it. Where key 0 is padding, a row's max can be a padding score
// (-1e9, whose product with log2(e) rounds by up to 64): such blocks keep the
// two-step exponent, exactly 1 at the max, so an all-padding sequence gets
// exactly the mean of v.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ mask, const float* __restrict__ shift,
                  float* __restrict__ out, float* __restrict__ lse, int n_heads, int s_q,
                  int s_k, float sm_scale) {
  if (mask == nullptr || mask[(long long)blockIdx.z * s_k] == 1.f)
    attend<T, true>(q, k, v, mask, shift, out, lse, n_heads, s_q, s_k, sm_scale);
  else
    attend<T, false>(q, k, v, mask, shift, out, lse, n_heads, s_q, s_k, sm_scale);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* mask, const float* shift,
           float* out, float* lse, int batch, int n_heads, int s_q, int s_k, float sm_scale,
           void* stream) {
  constexpr int smem = Layout<T>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (s_q < 1 || s_k < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_heads == 0) return 0;
  const dim3 grid((s_q + Layout<T>::BQ - 1) / Layout<T>::BQ, n_heads, batch);
  flash_attn_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, mask, shift, out, lse, n_heads, s_q, s_k, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, 64) fp32; k, v: (B, Sk, H, 64) fp32; all contiguous and
// 16-byte aligned; mask: (B, Sk) fp32 (1 attend, 0 pad) or null for no mask;
// shift: (B,) fp32 or null (0); lse: (B, H, Sq) fp32, or null to skip it.
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              const float* mask, const float* shift, float* out, float* lse,
                              int batch, int n_heads, int s_q, int s_k, float sm_scale,
                              void* stream) {
  return launch<float>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, sm_scale,
                       stream);
}

// The same with bf16 q, k, v; out and lse stay fp32.
extern "C" int flash_attn_bf16_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const float* mask,
                                   const float* shift, float* out, float* lse, int batch,
                                   int n_heads, int s_q, int s_k, float sm_scale,
                                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k,
                               sm_scale, stream);
}
