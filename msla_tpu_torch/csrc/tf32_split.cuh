// 3xTF32: an fp32 product on the TF32 tensor cores, each fp32 operand x split
// as hi = tf32(x), lo = tf32(x - hi) (x = hi + lo + O(2^-22 |x|), each part a
// TF32 value, so each product of two parts is exact in fp32), and lo.hi,
// hi.lo, then hi.hi added into one fp32 accumulator; lo.lo (~2^-22 of the
// product) is dropped. ops/tf32.py emulates it in plain PyTorch.
// Used by flash_attn.cu, mlm_argmax.cu, conv_stem.cu, deconv_stem.cu and
// vq_search.cuh and vq_stream.cuh (nearest_codes.cu, vq_fused.cu, vq_lean.cu).
#pragma once

#include <stdint.h>

namespace tf32_split {

// cvt.rna.tf32.f32 (round to nearest, ties away) as bit arithmetic: add half
// a TF32 ulp to the magnitude and clear the 13 low bits. The same value for
// finite x in 2 instructions; ptxas makes the cvt 4 (an isfinite test and a
// select besides).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), each part a TF32 value
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32(f);
  lo = tf32(f - __uint_as_float(hi));
}

// c += a . b over one m16n8k8 tile: tf32 inputs, fp32 accumulators. A: a0
// (row g, column t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B: b0
// (row t, column g), b1 (t + 4, g); C: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo.hi, hi.lo, then hi.hi into one accumulator (#6 fp32's order)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

}  // namespace tf32_split
