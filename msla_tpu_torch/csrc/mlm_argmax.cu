// Fused tied-decoder argmax of a masked LM:
//   ids[m]  = argmax_v (h[m] . E[v] + b[v])           (first maximum wins)
//   conf[m] = exp(max_v logit - logsumexp_v logit)     (conf variant)
// with the logits on the tensor cores in 3xTF32, never in device memory; and,
// for the bf16 compute_dtype, the same on bf16 h and E in one bf16 pass.
//
// Replaces: msla_tpu/ops/mlm_argmax.py:47 _argmax_kernel and :67
// _argmax_conf_kernel (mlm_argmax_pallas).
//
// Bounds on an H100, at the batch-16 Audio-BERT call: M = 352 x 512 = 180,224
// rows of width 768 against V = 30,522 vocab rows, 2*M*V*768 = 8.45e12 FLOP;
// the inputs are 554 MB + 94 MB, the outputs 0.7 MB (1.4 MB with conf), and
// the logits it never writes would be 22 GB.
// - fp32 outside the tensor cores (67 TFLOP/s): at least 126.1 ms. cuBLAS's
//   SGEMM runs near 77 % of that rate, so a SIMT kernel cannot clearly beat
//   SGEMM + argmax.
// - TF32 on the tensor cores (495 TFLOP/s dense): the function's 8.45e12
//   operations take at least 17.1 ms, bound by operations: the bound the
//   kernel is held to. The 3xTF32 design runs three products, 2.54e13
//   operations, so it cannot go below 51.2 ms.
// - L2: a block of BM rows re-reads its (BM, 768) slab of h for each tile of
//   BN vocab rows (the slab does not fit in shared memory), so the L2 carries
//   (BM + BN) * 768 * 4 B per (row block, vocab tile): 265 GB a call at
//   128 x 128, 199 GB at 128 x 256, 133 GB at 256 x 256. L2 bandwidth is not
//   published; at ~2 TB/s 199 GB is of the order of the compute bound.
//
// Design:
// - 3xTF32: each fp32 operand x is split as hi = tf32(x), lo = tf32(x - hi),
//   with cvt.rna.tf32.f32's rounding, and each k8 step runs lo_h.hi_E,
//   hi_h.lo_E, then hi_h.hi_E into one fp32 accumulator (the order of #9's
//   split3). hi + lo carry ~22 bits of x, so each product is good to ~2^-21
//   where one TF32 pass (~11 bits) flips near-ties. The sum is not fp32's:
//   the tensor cores' accumulator loses up to an ulp of the running sum at
//   each of its 288 accumulations (on an H100 it rounds a positive sum down,
//   as an adder that truncates), so a logit of 83 whose terms all add comes
//   out up to ~1e-5 of itself low, several times cuBLAS's fp32 error
//   (chip_smoke.py's coherent rows hold it to that bound). Promoting
//   partial sums into a second accumulator would cure it, but needs 128
//   more registers a thread than the m64n256 tile leaves, and 128-wide
//   tiles, which leave them, lose to SGEMM + argmax.
//   E is split on chip, once per block and chunk, into shared memory: a
//   pre-split E in device memory would double the E bytes every row block
//   reads through L2.
// - Tiles: a block of two warpgroups owns BM = 128 rows and walks the vocab in
//   tiles of BN = 256 (199 GB through L2); each warpgroup runs
//   wgmma.m64n256k8 on its 64 rows, 128 fp32 accumulators a thread. 256 x 256
//   would need four such warpgroups, 512 threads at over 128 registers: more
//   than the register file. One block an SM; 1,408 blocks are 10.7 waves, so
//   the partial last wave costs at most 3 % (a two-way vocab split gives 21.3
//   waves, the same 3 %), and the grid is a plain one.
// - Loads: a ring of 4 stages of 16-deep fp32 k-chunks filled by cp.async;
//   rows padded to 20 floats so that the split pass reads 8 rows' 16 B at
//   once from 32 banks. Rows past M and vocab rows past V are zero-filled
//   (src-size 0). The split pass writes each chunk's hi and lo of h and E, in
//   wgmma's K-major layout with the 64-byte swizzle (a row's four 16-byte
//   groups XOR (row / 2) % 4: 8 rows of one group hit 32 banks), into one of
//   two buffers while the tensor cores work on the other, so the split
//   overlaps the products; two barriers a chunk. 16-deep chunks, because four
//   32-deep fp32 stages (192 KB) and the split buffers (192 KB) would not fit
//   in 227 KB.
// - Epilogue in registers: a wgmma accumulator gives a thread 2 rows and 64
//   columns of each vocab tile. After each tile it adds the bias (-inf past V)
//   and folds its columns into a running (max, first index) per row in
//   ascending column order with a strict >, and in the conf variant into a
//   running sum of exp(logit - max). The four threads of a quad hold the same
//   rows and combine by shuffles, by "greater, or equal and lower index" (the
//   first maximum in any order); the sums combine in a fixed order, so conf
//   has the same bits run after run.
//
// bf16 (mlm_argmax_bf16_kernel; the Pallas kernel on bf16 h and E, the fp32
// bias, msla_tpu/models/bert.py:116-121, :213):
// - Bound: the same 8.45e12 FLOP at the bf16 tensor-core peak (989 TFLOP/s),
//   8.5 ms, bound by operations; the inputs are 277 MB + 47 MB. Through L2 a
//   block still re-reads its slab of h for each vocab tile: 100 GB a call at
//   128 x 256 in bf16.
// - The products of two bf16 values are exact in the tensor cores' fp32
//   accumulator, so one wgmma.m64n256k16 pass a k16 step is the function; no
//   split. The accumulator's own rounding (up to an ulp of the running sum at
//   each of its 48 k16 accumulations, as for 3xTF32's 288) is the only part
//   that is not the plain version's fp32 sum.
// - cp.async writes each 64-deep chunk of h and E straight into the swizzled
//   layout wgmma reads, as two 32-deep halves (one 64-byte row each): 48 KB a
//   stage, four stages in 192 KB. One barrier a chunk: at chunk s it tells
//   every thread that chunk s has landed and that both warpgroups have waited
//   for chunk s - 2's products, whose stage then takes chunk s + 2.
// - Tiles, the epilogue, the first-maximum rule and the online logsumexp are
//   the fp32 kernel's (fold_tile, store_best).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int K = 768;                      // hidden width the kernel is compiled for
constexpr int BM = 128;                     // rows per block, 64 per warpgroup
constexpr int BN = 256;                     // vocab rows per tile
constexpr int BK = 16;                      // reduction chunk of one ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int CHUNKS = K / BK;              // ring stages per vocab tile
constexpr int PAD = BK + 4;                 // floats per fp32 row in the ring
constexpr int RING_F = (BM + BN) * PAD;     // floats of one ring stage
constexpr int A_F = BM * BK, B_F = BN * BK; // floats of one split operand
constexpr int SPLIT_F = 2 * (A_F + B_F);    // h hi, h lo, E hi, E lo
constexpr int SMEM_BYTES = (STAGES * RING_F + 2 * SPLIT_F) * (int)sizeof(float);  // 221,184
constexpr int A_UNITS = A_F / 4 / THREADS, B_UNITS = B_F / 4 / THREADS;  // 16 B a thread: 2, 4
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

// cvt.rna.tf32.f32 (round to nearest, ties away) as bit arithmetic: add half
// a TF32 ulp to the magnitude and clear the 13 low bits. The same value for
// finite x in 2 instructions; ptxas makes the cvt 4 (an isfinite test and a
// select besides).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi and lo of 4 values: x = hi + lo + O(2^-22 |x|), each part a TF32 value
__device__ __forceinline__ void split_store(float* hi, float* lo, float4 v) {
  uint4 x, y;
  x.x = tf32(v.x); x.y = tf32(v.y); x.z = tf32(v.z); x.w = tf32(v.w);
  y.x = tf32(v.x - __uint_as_float(x.x)); y.y = tf32(v.y - __uint_as_float(x.y));
  y.z = tf32(v.z - __uint_as_float(x.z)); y.w = tf32(v.w - __uint_as_float(x.w));
  *reinterpret_cast<uint4*>(hi) = x;
  *reinterpret_cast<uint4*>(lo) = y;
}

// 16-byte unit u of an R-row chunk: row (u / 32 % (R / 8)) * 8 + u % 8, k-group
// (u / 32 / (R / 8)) * 4 + u / 8 % 4. A warp covers 8 rows x 4 k-groups: 64 B
// of each row from global memory, and 8 rows of one k-group on 32 banks in
// the split layout.
template <int R>
__device__ __forceinline__ void unit(int u, int& row, int& kg) {
  const int rest = u >> 5;
  row = (rest % (R / 8)) * 8 + (u & 7);
  kg = (rest / (R / 8)) * 4 + ((u >> 3) & 3);
}

// Descriptor of a K-major operand with the 64-byte swizzle: rows of 16 TF32
// values (64 B), 16-byte group kg of row r at r * 64 + (kg ^ (r / 2 % 4)) * 16
// from a 512-byte-aligned base; the next 8 rows (SBO) 512 B on, LBO unused.
// A k8 step starts 32 B into the row.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
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

// d (+)= a . b over m64n256k8, TF32 from shared memory, fp32 accumulators;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " ACC_REGS
               ", %128, %129, p, 1, 1;\n}\n"
               : ACC_OPERANDS(d)
               : "l"(da), "l"(db), "r"(scale_d));
}

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

// An empty asm that reads and writes every accumulator register, put after
// each wgmma.wait_group and before each wgmma.fence: the compiler may then
// move no read of d above the wait and no write of d below the fence
// (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Fold a finished vocab tile's logits into the running best of this thread's
// two rows: d[4 j + 2 r + e] is row g + 8 r, column col0 + 8 j + e. The bias is
// added (-inf past V), the columns are taken in ascending order with a strict
// >, and the conf variant keeps a running sum of exp(logit - max).
template <bool WITH_CONF>
__device__ __forceinline__ void fold_tile(float (&d)[128], Best (&best)[2], int col0,
                                          const float* __restrict__ bias, int vocab) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      const float b = col < vocab ? __ldg(bias + col) : -CUDART_INF_F;
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

template <bool WITH_CONF>
__global__ void __launch_bounds__(THREADS, 1)
mlm_argmax_kernel(const float* __restrict__ h, const float* __restrict__ emb,
                  const float* __restrict__ bias, int* __restrict__ ids,
                  float* __restrict__ conf, long long m_rows, int vocab) {
  extern __shared__ __align__(1024) float smem[];  // the swizzle needs 512-byte rows of 8
  float* ring = smem;                        // [STAGES][BM + BN][PAD] fp32
  float* split = smem + STAGES * RING_F;     // [2][h hi, h lo, E hi, E lo]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // the accumulator's row group, column pair
  const int wg = warp >> 2;                  // warpgroup: rows 64 wg..
  const long long m0 = (long long)blockIdx.x * BM;
  const int n_tiles = (vocab + BN - 1) / BN;
  const int steps = n_tiles * CHUNKS;        // chunk `step`: k-chunk step % CHUNKS of tile step / CHUNKS

  auto load = [&](int step) {
    if (step < steps) {
      float* stage = ring + (step % STAGES) * RING_F;
      const int n0 = (step / CHUNKS) * BN, k0 = (step % CHUNKS) * BK;
#pragma unroll
      for (int q = 0; q < A_UNITS; ++q) {
        int row, kg;
        unit<BM>(tid + THREADS * q, row, kg);
        const bool ok = m0 + row < m_rows;
        cp_async16(stage + row * PAD + 4 * kg, ok ? h + (m0 + row) * K + k0 + 4 * kg : h, ok);
      }
#pragma unroll
      for (int q = 0; q < B_UNITS; ++q) {
        int row, kg;
        unit<BN>(tid + THREADS * q, row, kg);
        const bool ok = n0 + row < vocab;
        cp_async16(stage + (BM + row) * PAD + 4 * kg,
                   ok ? emb + (long long)(n0 + row) * K + k0 + 4 * kg : emb, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto split_chunk = [&](int step) {  // ring stage of `step` -> split buffer step % 2
    const float* stage = ring + (step % STAGES) * RING_F;
    float* ah = split + (step & 1) * SPLIT_F;
    float* bh = ah + 2 * A_F;
#pragma unroll
    for (int q = 0; q < A_UNITS; ++q) {
      int row, kg;
      unit<BM>(tid + THREADS * q, row, kg);
      const int o = row * 16 + ((kg ^ ((row >> 1) & 3)) * 4);
      split_store(ah + o, ah + A_F + o,
                  *reinterpret_cast<const float4*>(stage + row * PAD + 4 * kg));
    }
#pragma unroll
    for (int q = 0; q < B_UNITS; ++q) {
      int row, kg;
      unit<BN>(tid + THREADS * q, row, kg);
      const int o = row * 16 + ((kg ^ ((row >> 1) & 3)) * 4);
      split_store(bh + o, bh + B_F + o,
                  *reinterpret_cast<const float4*>(stage + (BM + row) * PAD + 4 * kg));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  // this thread's rows 64 wg + 16 (warp % 4) + g + 8 r
  Best best[2] = {{-CUDART_INF_F, 0.f, NO_INDEX}, {-CUDART_INF_F, 0.f, NO_INDEX}};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
  __syncthreads();
  split_chunk(0);
  __syncthreads();

#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    const float* ah = split + (step & 1) * SPLIT_F + wg * 64 * 16;
    const float* bh = split + (step & 1) * SPLIT_F + 2 * A_F;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // k-groups 2 kk, 2 kk + 1
      const uint64_t dah = desc(ah + 8 * kk), dal = desc(ah + A_F + 8 * kk);
      const uint64_t dbh = desc(bh + 8 * kk), dbl = desc(bh + B_F + 8 * kk);
      wgmma(d, dal, dbh, (step % CHUNKS) + kk != 0);  // a tile's first product overwrites
      wgmma(d, dah, dbl, 1);
      wgmma(d, dah, dbh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step - 1's are done
    fence_acc(d);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 3) : "memory");  // step + 1 is in
    __syncthreads();  // no warpgroup reads split buffer (step + 1) % 2 any more
    load(step + STAGES - 1);  // into the stage step - 1 held
    if (step + 1 < steps) split_chunk(step + 1);

    if (step % CHUNKS == CHUNKS - 1) {  // the tile is complete: fold it
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      fold_tile<WITH_CONF>(d, best, (step / CHUNKS) * BN + 2 * t, bias, vocab);
    }
    __syncthreads();  // split buffer (step + 1) % 2 is written
  }

  store_best<WITH_CONF>(best, m0 + wg * 64 + (warp & 3) * 16 + g, m_rows, t, ids, conf);
}

template <bool WITH_CONF>
int launch(const float* h, const float* emb, const float* bias, int* ids, float* conf,
           long long m_rows, int vocab, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlm_argmax_kernel<WITH_CONF>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (m_rows == 0) return 0;
  const long long blocks = (m_rows + BM - 1) / BM;
  mlm_argmax_kernel<WITH_CONF><<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      h, emb, bias, ids, conf, m_rows, vocab);
  return (int)cudaGetLastError();
}

// bf16 (the bf16 compute_dtype): a ring stage holds a 64-deep chunk of the
// block's BM rows of h and the tile's BN rows of E as two 32-deep halves, each
// row of a half 64 bytes in wgmma's K-major layout with the 64-byte swizzle,
// as the split operands above. cp.async writes them there straight from
// device memory, so the tensor cores read the ring itself.
constexpr int BK16 = 64;                           // bf16 reduction depth of one stage
constexpr int CHUNKS16 = K / BK16;                 // stages per vocab tile: 12
constexpr int HALF16 = (BM + BN) * 32;             // bf16 values of one 32-deep half
constexpr int STAGE16 = 2 * HALF16;                // of one stage: 48 KB
constexpr int SMEM16_BYTES = STAGES * STAGE16 * 2;  // 196,608
constexpr int A16_UNITS = BM * BK16 / 8 / THREADS;  // 16 B a thread: 4
constexpr int B16_UNITS = BN * BK16 / 8 / THREADS;  // 8

// Where 16-byte unit c (0..7, 8 bf16 each along k) of row `row` of a stage's
// operand sits: its half, then the 64-byte swizzle of the unit within it.
__device__ __forceinline__ int unit16(int row, int c) {
  return (c >> 2) * HALF16 + row * 32 + (((c & 3) ^ ((row >> 1) & 3)) * 8);
}

template <bool WITH_CONF>
__global__ void __launch_bounds__(THREADS, 1)
mlm_argmax_bf16_kernel(const __nv_bfloat16* __restrict__ h,
                       const __nv_bfloat16* __restrict__ emb, const float* __restrict__ bias,
                       int* __restrict__ ids, float* __restrict__ conf, long long m_rows,
                       int vocab) {
  extern __shared__ __align__(1024) __nv_bfloat16 ring16[];  // [STAGES][2 halves][BM + BN][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int steps = (vocab + BN - 1) / BN * CHUNKS16;

  // chunk `step` (k-chunk step % CHUNKS16 of vocab tile step / CHUNKS16) into
  // stage step % STAGES; a warp reads 4 rows' 128 contiguous bytes
  auto load = [&](int step) {
    if (step < steps) {
      __nv_bfloat16* stage = ring16 + (step % STAGES) * STAGE16;
      const int n0 = (step / CHUNKS16) * BN, k0 = (step % CHUNKS16) * BK16;
#pragma unroll
      for (int q = 0; q < A16_UNITS; ++q) {
        const int u = tid + THREADS * q, row = u >> 3, c = u & 7;
        const bool ok = m0 + row < m_rows;
        cp_async16(stage + unit16(row, c), ok ? h + (m0 + row) * K + k0 + 8 * c : h, ok);
      }
#pragma unroll
      for (int q = 0; q < B16_UNITS; ++q) {
        const int u = tid + THREADS * q, row = u >> 3, c = u & 7;
        const bool ok = n0 + row < vocab;
        cp_async16(stage + unit16(BM + row, c),
                   ok ? emb + (long long)(n0 + row) * K + k0 + 8 * c : emb, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  Best best[2] = {{-CUDART_INF_F, 0.f, NO_INDEX}, {-CUDART_INF_F, 0.f, NO_INDEX}};

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) load(s);

#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 3) : "memory");  // step is in
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma to read
    // every thread's copies of `step` are in, and both warpgroups are past
    // their wait for step - 2's products: its stage may be refilled
    __syncthreads();
    load(step + STAGES - 2);
    const __nv_bfloat16* stage = ring16 + (step % STAGES) * STAGE16;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {  // half kk / 2, 32 bytes into its rows for odd kk
      const __nv_bfloat16* half = stage + (kk >> 1) * HALF16 + 16 * (kk & 1);
      wgmma_bf16(d, desc(half + wg * 64 * 32), desc(half + BM * 32),
                 (step % CHUNKS16) + kk != 0);  // a tile's first product overwrites
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step - 1's are done
    fence_acc(d);

    if (step % CHUNKS16 == CHUNKS16 - 1) {  // the tile is complete: fold it
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      fold_tile<WITH_CONF>(d, best, (step / CHUNKS16) * BN + 2 * t, bias, vocab);
    }
  }

  store_best<WITH_CONF>(best, m0 + wg * 64 + (warp & 3) * 16 + g, m_rows, t, ids, conf);
}

template <bool WITH_CONF>
int launch_bf16(const __nv_bfloat16* h, const __nv_bfloat16* emb, const float* bias, int* ids,
                float* conf, long long m_rows, int vocab, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mlm_argmax_bf16_kernel<WITH_CONF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM16_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (m_rows == 0) return 0;
  const long long blocks = (m_rows + BM - 1) / BM;
  mlm_argmax_bf16_kernel<WITH_CONF>
      <<<(unsigned)blocks, THREADS, SMEM16_BYTES, (cudaStream_t)stream>>>(
          h, emb, bias, ids, conf, m_rows, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

// h: (M, 768), emb: (V, 768), bias: (V,) fp32 contiguous, h and emb 16-byte
// aligned; ids: (M,) int32.
extern "C" int mlm_argmax_fwd(const float* h, const float* emb, const float* bias, int* ids,
                              long long m_rows, int vocab, void* stream) {
  return launch<false>(h, emb, bias, ids, nullptr, m_rows, vocab, stream);
}

// The same, plus conf: (M,) fp32, the softmax probability of each pick.
extern "C" int mlm_argmax_conf_fwd(const float* h, const float* emb, const float* bias,
                                   int* ids, float* conf, long long m_rows, int vocab,
                                   void* stream) {
  return launch<true>(h, emb, bias, ids, conf, m_rows, vocab, stream);
}

// bf16 h: (M, 768) and emb: (V, 768), 16-byte aligned, fp32 bias: (V,); ids as
// above (the logits summed in fp32 on the tensor cores).
extern "C" int mlm_argmax_bf16_fwd(const __nv_bfloat16* h, const __nv_bfloat16* emb,
                                   const float* bias, int* ids, long long m_rows, int vocab,
                                   void* stream) {
  return launch_bf16<false>(h, emb, bias, ids, nullptr, m_rows, vocab, stream);
}

// The same, plus conf.
extern "C" int mlm_argmax_conf_bf16_fwd(const __nv_bfloat16* h, const __nv_bfloat16* emb,
                                        const float* bias, int* ids, float* conf,
                                        long long m_rows, int vocab, void* stream) {
  return launch_bf16<true>(h, emb, bias, ids, conf, m_rows, vocab, stream);
}
