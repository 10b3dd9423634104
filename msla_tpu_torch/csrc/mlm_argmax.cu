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
// bf16 (tma_ws::mlm_argmax_bf16_kernel; the Pallas kernel on bf16 h and E, the
// fp32 bias, msla_tpu/models/bert.py:116-121, :213):
// - Bound: the same 8.45e12 FLOP at the bf16 tensor-core peak (989 TFLOP/s),
//   8.5 ms, bound by operations; the inputs are 277 MB + 47 MB. The products
//   of two bf16 values are exact in the tensor cores' fp32 accumulator, so one
//   wgmma.m64n256k16 pass a k16 step is the function; the accumulator's own
//   rounding (up to an ulp of the running sum at each of its 48 k16 steps) is
//   the only part that is not the plain version's fp32 sum.
// - What bound the first bf16 design (a cp.async ring that all threads fill, a
//   __syncthreads a 64-deep chunk, both warpgroups folding each finished tile
//   at once while no product runs): its probes on an H100
//   (mlm_argmax_probe.cu, PERF.md §7) took about a tenth off each without the
//   fold or without the barrier, and nothing with E held in L2; its blocks
//   pulled ~100 GB a call through L2 (each 128-row block re-reads its slab of h
//   for every 256-wide vocab tile, and every E tile once a block: 1,408 x 120
//   x (128 + 256) x 768 x 2 B) at 4.4 TB/s.
// - Design: blocks of 128 rows in clusters of CLUSTER = 2 along M walk the
//   vocab in step; each loads its h chunk and half of the E tile by TMA and
//   multicasts that half into both blocks, so a tile's E crosses L2 once a
//   cluster: 66 GB a call. Clusters of 4 and 8 (50 and 42 GB) were no faster
//   on the card. A ring of 4 stages of 64-deep chunks (48 KB: h 128 x 64 and
//   E 256 x 64, rows of 128 B in the 128-byte swizzle that wgmma reads) is
//   filled by one producer thread (its warpgroup keeps 24 registers,
//   setmaxnreg) and drained by two consumer warpgroups of 64 rows x 256
//   columns (wgmma.m64n256k16, 128 fp32 accumulators a thread, 240
//   registers). Full barriers take the producer's arrival and the stage's
//   bytes (TMA zero-fills rows past M and V); empty barriers take an arrival
//   of each consumer warp of both blocks, since each block's producer writes
//   into both. No __syncthreads in the mainloop; one wgmma group stays in
//   flight while the next stage is awaited. The second consumer starts LAG
//   = 2 chunks behind the first (bar.sync 1), so that one warpgroup's fold
//   of a finished tile runs while the other's products run, as far as the
//   4-stage ring lets them drift apart; staggers of 0, 1 and 3 chunks were
//   no faster on the card. The fold (fold_tile_bf16) is fold_tile's, with the conf sums on
//   ex2.approx, which keeps the conf variant inside 240 registers.
// - A block past M (M not a multiple of 256) still loads its half of E for
//   its partner and arrives on every barrier; its rows arrive as zeros and
//   are never stored. An mbarrier wait longer than 2 s traps, so a hang fails
//   the launch with an error. The tensor maps are encoded on the host once a
//   call (h's pointer changes) and passed as __grid_constant__ parameters.
// - Grid: a plain one of ceil(M / 128) blocks rounded up to whole clusters,
//   one block an SM (193 KB of shared memory): 1,408 blocks are 10.7 waves of
//   132, so the partial last wave costs at most 3 %.
// - Tiles, the first-maximum rule, the online logsumexp and the quad's
//   combine are the fp32 kernel's (mlm_argmax.cuh).
#include <cuda.h>  // CUtensorMap and its enums; libcuda's functions are looked up at run time

#include "mlm_argmax.cuh"
#include "tf32_split.cuh"

namespace {

using namespace mlm;

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

using tf32_split::tf32;  // cvt.rna.tf32.f32's rounding

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

// d (+)= a . b over m64n256k8, TF32 from shared memory, fp32 accumulators;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " ACC_REGS
               ", %128, %129, p, 1, 1;\n}\n"
               : ACC_OPERANDS(d)
               : "l"(da), "l"(db), "r"(scale_d));
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

// ---- bf16: TMA, a producer warp and two consumer warpgroups ------------------

namespace tma_ws {

constexpr int CLUSTER = 2;                  // blocks along M that share each E tile
constexpr int BK = 64;                      // bf16 depth of a stage: one 128-byte row
constexpr int CHUNKS = K / BK;              // stages per vocab tile: 12
constexpr int STAGES = 4;
constexpr int H_BYTES = BM * BK * 2;        // the block's rows of h, a stage: 16 KB
constexpr int E_BYTES = BN * BK * 2;        // the tile's rows of E, a stage: 32 KB
constexpr int STAGE_BYTES = H_BYTES + E_BYTES;
constexpr int E_PART = BN / CLUSTER;        // rows of E each block loads for the cluster
constexpr int THREADS = 384;                // producer warpgroup + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int LAG = 2;                      // chunks the second consumer starts behind
static_assert(LAG > 0 && LAG < STAGES, "the first consumer runs LAG chunks alone");
// the ring, the full and empty barriers, and 1 KB to align the ring to 1,024 B
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // 197,696
constexpr long long WAIT_NS = 2000000000LL;  // an mbarrier wait longer than this traps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// Wait until the phase of parity `parity` of the mbarrier at `bar` has
// completed. A wait that outlasts WAIT_NS traps: the launch then fails with
// an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  if (done) return;
  long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  for (;;) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > WAIT_NS) __trap();
  }
}

// One arrival on the mbarrier at local address `bar` in block `cta` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile("{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [r];\n}\n"
               :: "r"(bar), "r"(cta) : "memory");
}

// Rows [c1, c1 + box rows) x depth [c0, c0 + 64) of a 2-D tensor map into
// this block's shared memory at `dst`, completing `bytes` on `bar`; rows
// past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// The same into `dst` of every block in `mask`, completing on each one's
// mbarrier at `bar`.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int c1, uint32_t bar, uint16_t mask) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
               :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar), "h"(mask) : "memory");
}

// 2^x on the SFU (ex2.approx.ftz.f32): 0 for x = -inf.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fold a finished vocab tile into this thread's two rows, as fold_tile does
// (the bias added, -inf past V, ascending columns with a strict >), with both
// rows in one pass over the columns, each bias used as it is loaded; and in
// the conf variant the sum of exp(logit - max) as 2^((logit - max) log2 e) on
// ex2.approx (relative error ~2^-22, the same bits run after run). Fewer
// values stay live than in fold_tile, so the conf variant fits the
// consumers' 240 registers.
template <bool WITH_CONF>
__device__ __forceinline__ void fold_tile_bf16(float (&d)[128], Best (&best)[2], int col0,
                                               const float* __restrict__ bias, int vocab) {
  const float m_old[2] = {best[0].m, best[1].m};
#pragma unroll
  for (int j = 0; j < 32; ++j)  // ascending columns, strict >
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      const float b = col < vocab ? __ldg(bias + col) : -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = d[4 * j + 2 * r + e] += b;
        if (v > best[r].m) {
          best[r].m = v;
          best[r].idx = col;
        }
      }
    }
  if (WITH_CONF) {
    constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Best& b = best[r];
      if (b.m == -CUDART_INF_F) continue;
      const float ml = b.m * LOG2E;
      float s = b.m > m_old[r] ? b.s * ex2(fmaf(m_old[r], LOG2E, -ml)) : b.s;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s += ex2(fmaf(d[4 * j + 2 * r + e], LOG2E, -ml));
      b.s = s;
    }
  }
}

template <bool WITH_CONF>
__global__ void __launch_bounds__(THREADS, 1) __cluster_dims__(CLUSTER, 1, 1)
mlm_argmax_bf16_kernel(const __grid_constant__ CUtensorMap map_h,
                       const __grid_constant__ CUtensorMap map_e,
                       const float* __restrict__ bias, int* __restrict__ ids,
                       float* __restrict__ conf, long long m_rows, int vocab) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;  // [STAGES][h | E]
  const uint32_t full = ring + STAGES * STAGE_BYTES;            // STAGES mbarriers
  const uint32_t empty = full + STAGES * 8;                     // STAGES mbarriers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const uint32_t rank = cluster_rank();
  const long long m0 = (long long)blockIdx.x * BM;
  const int n_tiles = (vocab + BN - 1) / BN;
  const int steps = n_tiles * CHUNKS;  // chunk `step`: k-chunk step % CHUNKS of step / CHUNKS

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer's arrival and the stage's bytes (h, and E from
      // every block of the cluster); empty: one arrival of each consumer
      // warp of every block of the cluster, which all read the E the
      // producer writes into them
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(full + 8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(empty + 8 * s), "r"(8 * CLUSTER));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any block uses them

  if (wg == 0) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 0 && lane == 0) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        const uint32_t parity = ((step / STAGES) & 1) ^ 1;  // a fresh stage is free
        mbar_wait(empty + 8 * s, parity);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(full + 8 * s), "r"(STAGE_BYTES) : "memory");
        const int k0 = (step % CHUNKS) * BK, n0 = (step / CHUNKS) * BN;
        const uint32_t stage = ring + s * STAGE_BYTES;
        tma_load(stage, &map_h, k0, (int)m0, full + 8 * s);
        tma_load_multicast(stage + H_BYTES + rank * (E_PART * BK * 2), &map_e, k0,
                           n0 + (int)rank * E_PART, full + 8 * s, (1 << CLUSTER) - 1);
      }
    }
    __syncwarp();
  } else {  // consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1, g = lane >> 2, t = lane & 3;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    Best best[2] = {{-CUDART_INF_F, 0.f, NO_INDEX}, {-CUDART_INF_F, 0.f, NO_INDEX}};
    // the second warpgroup starts LAG chunks behind the first, so that
    // their folds fall while the other one's products run (named barrier 1)
    if (cw == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    auto release = [&](int step) {  // each warp's arrival, in every block of the cluster
      if (lane < CLUSTER) mbar_arrive_cluster(empty + 8 * (step % STAGES), lane);
    };

    int step = 0;  // chunk `step` is k-chunk c of vocab tile n
#pragma unroll 1
    for (int n = 0; n < n_tiles; ++n) {
      fence_acc(d);  // the fold's writes of d come before the tile's first product
#pragma unroll 1
      for (int c = 0; c < CHUNKS; ++c, ++step) {
        const int s = step % STAGES;
        mbar_wait(full + 8 * s, (step / STAGES) & 1);
        const uint32_t stage = ring + s * STAGE_BYTES;
        const uint32_t a = stage + cw * 64 * BK * 2, b = stage + H_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // a tile's first product overwrites
          wgmma_bf16(d, desc128(a + 32 * kk), desc128(b + 32 * kk), c != 0 || kk != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (cw == 0 && step == LAG - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
        if (c < CHUNKS - 1) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // c - 1's are done
          if (c > 0) release(step - 1);
        }
      }
      // the tile is complete: release its last two stages and fold it
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      release(step - 2);
      release(step - 1);
      fold_tile_bf16<WITH_CONF>(d, best, n * BN + 2 * t, bias, vocab);
    }
    store_best<WITH_CONF>(best, m0 + cw * 64 + (warp & 3) * 16 + g, m_rows, t, ids, conf);
  }
  cluster_sync();  // no block leaves while another may still arrive on its barriers
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of a (rows, K) bf16 matrix read in boxes of box_rows x 64
// with the 128-byte swizzle, rows past its end read as zeros.
// cuTensorMapEncodeTiled lives in libcuda: it is looked up through
// cudaGetDriverEntryPoint, so the library links against the runtime alone.
int encode(CUtensorMap* map, const __nv_bfloat16* p, long long rows, int box_rows) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* sym = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess) return (int)cudaErrorSymbolNotFound;
    fn = (EncodeTiled)sym;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p, dims, strides, box,
                        step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool WITH_CONF>
int launch(const __nv_bfloat16* h, const __nv_bfloat16* emb, const float* bias, int* ids,
           float* conf, long long m_rows, int vocab, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mlm_argmax_bf16_kernel<WITH_CONF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (m_rows == 0) return 0;
  if (vocab < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map_h, map_e;  // h's pointer changes from call to call: encoded each call
  int status = encode(&map_h, h, m_rows, BM);
  if (status == 0) status = encode(&map_e, emb, vocab, E_PART);
  if (status != 0) return status;
  // whole clusters: a block past M loads its part of E for its partners,
  // and its own rows arrive as zeros and are never stored
  const long long blocks = ((m_rows + BM - 1) / BM + CLUSTER - 1) / CLUSTER * CLUSTER;
  mlm_argmax_bf16_kernel<WITH_CONF>
      <<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
          map_h, map_e, bias, ids, conf, m_rows, vocab);
  return (int)cudaGetLastError();
}

}  // namespace tma_ws

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

// bf16 h: (M, 768) and emb: (V, 768), 16-byte aligned, fp32 bias: (V,), V >= 1;
// ids as above (the logits summed in fp32 on the tensor cores).
extern "C" int mlm_argmax_bf16_fwd(const __nv_bfloat16* h, const __nv_bfloat16* emb,
                                   const float* bias, int* ids, long long m_rows, int vocab,
                                   void* stream) {
  return tma_ws::launch<false>(h, emb, bias, ids, nullptr, m_rows, vocab, stream);
}

// The same, plus conf.
extern "C" int mlm_argmax_conf_bf16_fwd(const __nv_bfloat16* h, const __nv_bfloat16* emb,
                                        const float* bias, int* ids, float* conf,
                                        long long m_rows, int vocab, void* stream) {
  return tma_ws::launch<true>(h, emb, bias, ids, conf, m_rows, vocab, stream);
}
