// The tiles of attention at any head width D from 1 to 256, shared by the
// any-width forward (flash_any.cu) and the backward (flash_bwd.cu): shared-
// memory tiles of Dp = D padded to the mma's k step (8 in fp32, 16 in bf16)
// with zero columns, and the two products every one of their kernels is made
// of, on mma.sync (fp32 in 3xTF32 on m16n8k8, tf32_split.cuh; bf16 on
// m16n8k16 bf16 -> fp32):
// - `scores`: C (16 x 8 NT) = X . Y^T over Dp, X the warp's 16 rows of one
//   tile and Y 8 NT rows of another: Q K^T (the forward, dQ), K Q^T (dK/dV),
//   dO V^T (dQ) and V dO^T (dK/dV). Zero columns add exact zeros.
// - `accumulate`: acc (16 x 8 NO) += P . Z, P a `scores` result in registers
//   (its m16n8 C layout) and Z (8 NT x Dp) a tile: P V (the forward), dS K
//   (dQ), P^T dO and dS^T Q (dK/dV). P never touches shared memory. In fp32
//   the C layout gives a thread P's columns 2t and 2t + 1 while the tf32 A
//   fragment wants t and t + 4; a sum does not care about its order, so A's
//   column t is P's column 2t and column t + 4 is 2t + 1, and the B fragment
//   reads Z's rows 2t and 2t + 1 to match (flash_attn.cu's trick). In bf16,
//   P is rounded to bf16 as it is packed into the A fragment: JAX's
//   p.astype(bf16) and ds.astype(bf16) (its TPU backward's rounding points).
// Only the accumulator's n8 tiles below `no` (Dp / 8, a run-time value) are
// computed; NO, their most, is a template parameter so that they stay in
// registers.
//
// Loads are element by element, coalesced across the block: a head's row of
// D values starts every D elements, on no 16-byte boundary at D = 26 (104 B
// in fp32, 52 B in bf16), so flash_attn.cu's 16-byte cp.async does not hold.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace flash_tiles {

using bf16 = __nv_bfloat16;
using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // a block's query rows (forward, dQ) or keys (dK/dV)
constexpr int MAX_D = 256;
constexpr float LOG2E = 1.4426950408889634f;

// The k step of an mma and the elements a shared row is padded by, per type.
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int K = 8, PAD = 4;
};
template <>
struct Op<bf16> {
  static constexpr int K = 16, PAD = 8;
};

// A class of padded widths, by NO = the accumulator's n8 tiles (Dp / 8 at
// most): the forward's keys a step and the backward's keys (dQ) or queries
// (dK/dV) a step; fewer where the accumulators take more registers.
template <int NO>
struct Class;
template <>
struct Class<4> {
  static constexpr int FWD = 64, BWD = 64;
};
template <>
struct Class<8> {
  static constexpr int FWD = 64, BWD = 64;
};
template <>
struct Class<16> {
  static constexpr int FWD = 64, BWD = 32;
};
template <>
struct Class<32> {
  static constexpr int FWD = 32, BWD = 16;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The class's NO for a padded width (32 / 64 / 128 / 256 columns).
__host__ __device__ constexpr int class_of(int dp) {
  return dp <= 32 ? 4 : dp <= 64 ? 8 : dp <= 128 ? 16 : 32;
}

// Class<no>::FWD and Class<no>::BWD of a run-time class.
template <int NO>
__host__ __device__ constexpr int step_of(bool fwd) {
  return fwd ? Class<NO>::FWD : Class<NO>::BWD;
}
__host__ __device__ constexpr int step(int no, bool fwd) {
  return no == 4 ? step_of<4>(fwd) : no == 8 ? step_of<8>(fwd)
                                   : no == 16 ? step_of<16>(fwd) : step_of<32>(fwd);
}
__host__ __device__ constexpr int fwd_step(int no) { return step(no, true); }
__host__ __device__ constexpr int bwd_step(int no) { return step(no, false); }

template <typename T>
__host__ __device__ constexpr int ld_of(int dp) {
  return dp + Op<T>::PAD;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __ushort_as_bfloat16(0);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + n) of one head (src: the head's first element, rows
// `stride` elements apart) into a (n, ld) shared tile of Dp columns: rows at
// or past `s` and columns at or past `d` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          long long stride, int row0, int n, int s, int d,
                                          int dp) {
  for (int i = threadIdx.x; i < n * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp;
    T val = zero<T>();
    if (row0 + r < s && c < d) val = src[(long long)(row0 + r) * stride + c];
    dst[r * ld + c] = val;
  }
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values as one mma operand register, `lo` at the lower half.
__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two fp32 values rounded to a bf16x2 word, a at the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b over one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void clear(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// c[j] = X . Y^T over dp columns: X's rows g and g + 8 from xs (the warp's
// row 0), Y's rows 8 j + g from ys; the m16n8 C layout: c[j][0], c[j][1] row
// g, columns 8 j + 2t, 8 j + 2t + 1; c[j][2], c[j][3] row g + 8. In 3xTF32.
template <int NT>
__device__ __forceinline__ void scores(float (&c)[NT][4], const float* xs, const float* ys,
                                       int ld, int dp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  clear(c);
  const float* x0 = xs + g * ld + t;
  for (int kk = 0; kk < dp; kk += 8) {
    const float a[4] = {x0[kk], x0[8 * ld + kk], x0[kk + 4], x0[8 * ld + kk + 4]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__float_as_uint(a[e]), ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* y = ys + (8 * j + g) * ld + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(__float_as_uint(y[0]), bh0, bl0);
      split(__float_as_uint(y[4]), bh1, bl1);
      mma_3xtf32(c[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The same on bf16 tiles: exact products, fp32 sums.
template <int NT>
__device__ __forceinline__ void scores(float (&c)[NT][4], const bf16* xs, const bf16* ys,
                                       int ld, int dp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  clear(c);
  const bf16* x0 = xs + g * ld + 2 * t;
  for (int kk = 0; kk < dp; kk += 16) {
    const uint32_t a[4] = {word(x0 + kk), word(x0 + 8 * ld + kk), word(x0 + kk + 8),
                           word(x0 + 8 * ld + kk + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* y = ys + (8 * j + g) * ld + kk + 2 * t;
      mma_bf16(c[j], a, word(y), word(y + 8));
    }
  }
}

// acc[e] += P . Z for e < no: P (16 x 8 NT) in the C layout of `scores`,
// Z's rows 0 .. 8 NT of zs, columns 8 e .. 8 e + 7. In 3xTF32, P split here.
template <int NT, int NO>
__device__ __forceinline__ void accumulate(float (&acc)[NO][4], const float (&p)[NT][4],
                                           const float* zs, int ld, int no, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {  // A column t is P's column 2t, column t + 4 is 2t + 1
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__float_as_uint(a[e]), ah[e], al[e]);
    const float* z0 = zs + (8 * j + 2 * t) * ld + g;  // Z's rows 2t, 2t + 1 of tile j
#pragma unroll
    for (int e = 0; e < NO; ++e)
      if (e < no) {
        uint32_t bh0, bl0, bh1, bl1;
        split(__float_as_uint(z0[8 * e]), bh0, bl0);
        split(__float_as_uint(z0[ld + 8 * e]), bh1, bl1);
        mma_3xtf32(acc[e], ah, al, bh0, bh1, bl0, bl1);
      }
  }
}

// The same on a bf16 Z, P rounded to bf16 as it is packed (NT even).
template <int NT, int NO>
__device__ __forceinline__ void accumulate(float (&acc)[NO][4], const float (&p)[NT][4],
                                           const bf16* zs, int ld, int no, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {  // P's columns 16 j .. 16 j + 15: tiles 2j, 2j + 1
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const bf16* z0 = zs + (16 * j + 2 * t) * ld + g;
#pragma unroll
    for (int e = 0; e < NO; ++e)
      if (e < no) {
        const bf16* z = z0 + 8 * e;
        mma_bf16(acc[e], a, pair(z[0], z[ld]), pair(z[8 * ld], z[9 * ld]));
      }
  }
}

// fl(fl(s sm_scale) + bias): the plain version's rounding, no FMA contraction.
__device__ __forceinline__ float scaled(float s, float sm_scale, float bias) {
  return __fadd_rn(__fmul_rn(s, sm_scale), bias);
}

// The bias of a key: (1 - mask) * -1e9 rounded (0 without a mask), -inf past
// the keys.
__device__ __forceinline__ float key_bias(const float* ms, int i, bool in_range) {
  if (!in_range) return -CUDART_INF_F;
  return ms ? __fmul_rn(1.f - ms[i], -1e9f) : 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P = exp((s - shift) - lse): 0 where s is -inf (a key past Sk) or lse +inf
// (a query row past Sq).
__device__ __forceinline__ float prob(float s, float shift, float lse) {
  return ex2(__fmul_rn(__fsub_rn(__fsub_rn(s, shift), lse), LOG2E));
}

// One dynamic shared-memory block, carved in order.
struct Carve {
  char* at;
  template <typename U>
  __device__ __forceinline__ U* take(size_t count) {
    U* p = reinterpret_cast<U*>(at);
    at += count * sizeof(U);
    return p;
  }
};

// Let a kernel take `smem` bytes of dynamic shared memory.
template <typename K>
int allow(K kernel_fn, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace flash_tiles
