// What the fused MLM argmax kernels share (mlm_argmax.cu, mlm_argmax_probe.cu):
// the m64n256 wgmma accumulator, its fold into a running (max, first index,
// sum of exponentials) per row, and the quad's combine and store. #9's
// forward (vq_precision.cu) runs the same m64n256k16 bf16 wgmma, with its A
// from registers, and folds its distances with the same fold and combine.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace mlm {

constexpr int K = 768;                      // hidden width the kernels are compiled for
constexpr int BM = 128;                     // rows per block, 64 per consumer warpgroup
constexpr int BN = 256;                     // vocab rows per tile
constexpr int NO_INDEX = 0x7fffffff;

struct Best {
  float m;    // running max logit
  float s;    // running sum of exp(logit - m) (conf variant)
  int idx;    // first column holding m
};

__device__ __forceinline__ void combine(Best& a, const Best& b, bool with_conf) {
  if (with_conf) {
    const float mx = fmaxf(a.m, b.m);
    const float sa = a.m == -CUDART_INF_F ? 0.f : a.s * expf(a.m - mx);
    const float sb = b.m == -CUDART_INF_F ? 0.f : b.s * expf(b.m - mx);
    a.s = sa + sb;
  }
  if (b.m > a.m || (b.m == a.m && b.idx < a.idx)) {
    a.m = b.m;
    a.idx = b.idx;
  }
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Descriptor of a K-major operand with the 64-byte swizzle: rows of 64 B,
// 16-byte group kg of row r at r * 64 + (kg ^ (r / 2 % 4)) * 16 from a
// 512-byte-aligned base; the next 8 rows (SBO) 512 B on, LBO unused.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// Descriptor of a K-major operand with the 128-byte swizzle, as TMA writes it:
// rows of 64 bf16 (128 B), 16-byte group kg of row r at r * 128 + (kg ^ r % 8)
// * 16 from a 1,024-byte-aligned base; 8 rows (SBO) 1,024 B apart, LBO
// unused. A k16 step starts 32 B into the rows.
__device__ __forceinline__ uint64_t desc128(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The 128 fp32 accumulators of an m64n256 wgmma: their PTX operands %0..%127
// and their asm constraints, read and written.
#define ACC_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19," \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37," \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73," \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91," \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108," \
  "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123," \
  "%124, %125, %126, %127" \
  "}"
#define ACC_OPERANDS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
  "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
  "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
  "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (+)= a . b over m64n256k16, bf16 from shared memory (both K-major),
// fp32 accumulators; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC_REGS
               ", %128, %129, p, 1, 1, 0, 0;\n}\n"
               : ACC_OPERANDS(d)
               : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers: the warp's 16 rows of the 64 as
// mma.m16n8k16's A fragment (a[0]: row g, columns 2t and 2t + 1; a[1]: row
// g + 8; a[2], a[3]: columns 2t + 8, 2t + 9), bf16x2 each. The registers are
// read until the wgmma completes: fence them after its wait (fence_frag).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC_REGS
               ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
               : ACC_OPERANDS(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// An empty asm that reads and writes every accumulator register, put after
// each wgmma.wait_group and before each wgmma.fence: the compiler may then
// move no read of d above the wait and no write of d below the fence
// (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for a wgmma's A fragments in registers: after its wait, so that
// the compiler reuses none of them while the wgmma may still read them.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Fold a finished tile of columns into the running best of this thread's two
// rows: d[4 j + 2 r + e] is row g + 8 r, column col0 + 8 j + e. bias(col) is
// added, the columns are taken in ascending order with a strict >, and the
// conf variant keeps a running sum of exp(logit - max).
template <bool WITH_CONF, class Bias>
__device__ __forceinline__ void fold_tile(float (&d)[128], Best (&best)[2], int col0,
                                          Bias bias) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias(col0 + 8 * j + e);
      d[4 * j + e] += b;
      d[4 * j + 2 + e] += b;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    Best& b = best[r];
    const float m_old = b.m;
#pragma unroll
    for (int j = 0; j < 32; ++j)  // ascending columns, strict >
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (d[4 * j + 2 * r + e] > b.m) {
          b.m = d[4 * j + 2 * r + e];
          b.idx = col0 + 8 * j + e;
        }
    if (WITH_CONF && b.m != -CUDART_INF_F) {
      float s = b.m > m_old ? b.s * expf(m_old - b.m) : b.s;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s += expf(d[4 * j + 2 * r + e] - b.m);
      b.s = s;
    }
  }
}

// The MLM's fold: the vocab bias, -inf past V.
template <bool WITH_CONF>
__device__ __forceinline__ void fold_tile(float (&d)[128], Best (&best)[2], int col0,
                                          const float* __restrict__ bias, int vocab) {
  const float* b = bias;
  fold_tile<WITH_CONF>(d, best, col0, [b, vocab](int col) {
    return col < vocab ? __ldg(b + col) : -CUDART_INF_F;
  });
}

// Combine the quad's four partial bests of its two rows (rows row0 and
// row0 + 8) and write them: the id, and in the conf variant the probability.
template <bool WITH_CONF>
__device__ __forceinline__ void store_best(Best (&best)[2], long long row0, long long m_rows,
                                           int t, int* __restrict__ ids,
                                           float* __restrict__ conf) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // the quad's 4 threads hold the same rows
      Best other;
      other.m = __shfl_xor_sync(0xffffffffu, best[r].m, o);
      other.s = __shfl_xor_sync(0xffffffffu, best[r].s, o);
      other.idx = __shfl_xor_sync(0xffffffffu, best[r].idx, o);
      combine(best[r], other, WITH_CONF);
    }
    const long long row = row0 + 8 * r;
    if (t == 0 && row < m_rows) {
      ids[row] = best[r].idx;
      if (WITH_CONF) {
        const float lse = logf(best[r].s) + best[r].m;
        conf[row] = expf(best[r].m - lse);
      }
    }
  }
}

}  // namespace mlm
