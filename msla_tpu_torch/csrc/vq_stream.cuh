// The streamed nearest-code search of K3 (nearest_codes.cu) and #4's forward
// (vq_fused.cu) at D = 128 and 256, the sweep's embedding widths
// (configs/hparams_search/optuna.yaml). The codebook does not fit in a
// block's shared memory there (D = 256, K = 512: 512 KB), so it passes
// through a ring of stages, each searched by every warp of the block. The
// function and its numbers are vq_search.cuh's: 3xTF32 on mma.sync, the same
// k8 steps in the same order (so the same distances, bit for bit), dist =
// |e|^2 - 2 acc in fp32 with |e|^2 from the wrapper's code_norms, a strict <
// fold in ascending code order, then the lower index on an equal dist.
//
// Bound on an H100 at N = 352,000 rows (a batch-32 sweep trial), K = 512,
// D = 256: 9.23e10 FLOP, 0.186 ms at the TF32 peak and 0.559 ms for the three
// products; 360.4 MB of x: 0.108 ms. The tensor cores' products are the
// bound. What held the first streamed design (vq_search.cuh's group of 32
// codes between two __syncthreads, 2 stages by cp.async, 4 warps a block at
// D = 256), and what this one does about it:
// 1. The TF32 split was repeated: each warp split each codebook element of a
//    group itself, and its A fragments again for every 32 codes. Here each
//    stage is split once for the block: the 8 consumer warps split it
//    together, in place, into a hi and a lo plane (each element once), and a
//    warp splits its A fragments once for every 64 codes (a warp's n-width).
//    The planes cost shared-memory bytes instead: a warp loads each B
//    fragment's hi and lo (16 bytes a pair of products' operands, twice the
//    fp32 element it split before), and the split reads and writes each
//    element once more.
// 2. Few warps: 8 consumer warps (2 a scheduler) at both widths. A block
//    tile's 128 rows are 4 slabs of 32 rows, each searched by 2 warps, one a
//    half of the stage's 128 codes; their bests are merged at the end
//    through shared memory (a named barrier a pair), the smaller dist, then
//    the smaller index. 128 rows, not 256, also at D = 128: 2,750 tiles at N
//    = 352,000 spread within 1 % over 132 SMs (1,375 would leave 6 %).
// 3. Barriers: one thread of a producer warpgroup fills a ring of 4 stages by
//    TMA, each a box of 16 columns (one pair of k8 steps) of 128 codes;
//    `full`, `split` and `empty` mbarriers a stage replace the block
//    barriers, so a warp waits only for the stage it reads, and may run a
//    stage ahead of another: it splits its share of the next stage before it
//    searches this one. The producer warpgroup gives its registers to the
//    consumers (setmaxnreg: 40 and 232 a thread), which 12 warps would hold
//    at 168 (3 warps on some scheduler); ptxas reports those 168 and
//    compiles the consumers' code to setmaxnreg's budget, without spills.
// 4. x ahead: the tile's x sits in shared memory as D / 16 slices of 16
//    columns. Slice s of the next block tile is copied (TMA, rows past N as
//    zeros) as soon as every warp has searched the last code group's stage of
//    slice s, so it streams in under the rest of that group: D / 16 - 1
//    stages before it is needed.
// 5. The codebook's L2 reads: a stage is read once a block tile, 4 bytes an
//    element: 1.44 GB of L2 reads at K = 512, D = 256 (0.72 GB at D = 128),
//    as before at D = 256 and twice before's at 128.
// 6. #4 spilled at D = 256 (255 registers): a consumer thread holds 64
//    accumulators, 32 A registers and 8 of B, with no |e|^2 or codebook in
//    shared memory; |e|^2 is read from device memory (L1) at each group's
//    fold, and #4's q and x from device memory (L2) after the search.
// mma.sync, not wgmma: 3xTF32 on wgmma would need x's hi and lo planes in
// shared memory (64 KB for 32 rows at D = 256) beside the stages, and wgmma
// loses up to an fp32 ulp of the running sum at each accumulation, which the
// planted close pairs 1e-4 apart at D = 256 may not survive.
// Shared memory: x 64 or 128 KB (128 rows), 4 stages of 16 KB, 2 KB for the
// pairs' merge, the mbarriers, and #4's histogram (4 B a code): 133,408 B +
// 4 K (D = 128) and 199,008 B + 4 K (D = 256), with #4's 64 static bytes, so
// #4 takes K up to 24,744 and 8,344; K3 any K (ops/nearest_codes.py
// search_smem_bytes).
#pragma once

#include "segment_sum.cuh"  // mbarrier waits that trap, TMA loads, tensor maps
#include "vq_search.cuh"

namespace vq_stream {

using segsum::mbar_arrive;
using segsum::mbar_wait;
using segsum::smem_addr;
using vq_search::FULL;
using vq_search::MT;

constexpr int DS = 16;                  // columns a stage: one pair of k8 steps
constexpr int STAGES = 4;               // ring slots
constexpr int PRODUCERS = 4;            // warps of the producer warpgroup (warps 0-3)
constexpr int CONSUMERS = 8;            // consumer warps (4-11)
constexpr int CTHREADS = 32 * CONSUMERS;
constexpr int THREADS = 32 * PRODUCERS + CTHREADS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int NT = 8;                   // n8 tiles a warp: 64 codes for each A split

// A consumer's thread index (0 .. CTHREADS - 1) and warp index (0 .. 7).
__device__ __forceinline__ int consumer_tid() { return (int)threadIdx.x - 32 * PRODUCERS; }
__device__ __forceinline__ int consumer_warp() { return consumer_tid() >> 5; }

constexpr int SLABS = 4;                           // 32-row slabs a block tile
constexpr int HALVES = CONSUMERS / SLABS;          // warps a slab, one a half of the codes
constexpr int TILE_ROWS = 32 * SLABS;              // a block tile: 128 rows
constexpr int STAGE_CODES = 8 * NT * HALVES;       // a stage's (and a group's) codes: 128
constexpr int PLANE = STAGE_CODES * DS * 4;        // bytes of a stage's hi (or lo) plane
constexpr int MERGE = CONSUMERS * 32 * 8;          // (dist, index) a row a warp
static_assert(HALVES == 2 && PLANE % 128 == 0, "two warps a slab; TMA boxes 128-byte aligned");

template <int D>
struct Shape {
  static_assert(D % DS == 0, "whole stages");
  static constexpr int SLICES = D / DS;                // stages a code group
  static constexpr int X_SLICE = TILE_ROWS * DS * 4;   // bytes of an x slice
  static constexpr int BARRIERS = 3 * STAGES + SLICES; // full, split, empty; x
  // dynamic shared memory before the histogram, with 128 bytes to align the base
  static constexpr size_t FIXED =
      128 + (size_t)SLICES * X_SLICE + (size_t)STAGES * 2 * PLANE + MERGE + BARRIERS * 8;
};

// Dynamic shared memory at K codes, with (#4) or without (K3) the histogram.
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int k_codes, bool with_hist) {
  return Shape<D>::FIXED + (with_hist ? (size_t)k_codes * 4 : 0);
}

template <int D>
struct Smem {
  float* x;         // [SLICES][TILE_ROWS][DS]
  float* ring;      // [STAGES][hi, lo][STAGE_CODES][DS]
  float2* merge;    // [CONSUMERS][32]
  uint32_t full, split, empty, xfull;  // mbarriers: [STAGES] x 3, [SLICES]
  int* hist;        // [K]
  __device__ explicit Smem(unsigned char* raw) {
    using S = Shape<D>;
    unsigned char* base = raw + ((128 - (smem_addr(raw) & 127)) & 127);
    x = reinterpret_cast<float*>(base);
    ring = x + S::SLICES * TILE_ROWS * DS;
    merge = reinterpret_cast<float2*>(ring + STAGES * 2 * STAGE_CODES * DS);
    full = smem_addr(reinterpret_cast<unsigned char*>(merge) + MERGE);
    split = full + 8 * STAGES;
    empty = split + 8 * STAGES;
    xfull = empty + 8 * STAGES;
    hist = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(merge) + MERGE +
                                  S::BARRIERS * 8);
  }
  __device__ float* hi(int slot) const { return ring + slot * 2 * STAGE_CODES * DS; }
  __device__ float* lo(int slot) const { return hi(slot) + STAGE_CODES * DS; }
};

// The barriers' counts; a __syncthreads must follow before any is used.
template <int D>
__device__ __forceinline__ void init_barriers(const Smem<D>& sm) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < STAGES; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(sm.full + 8 * s));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(sm.split + 8 * s),
                 "r"(CTHREADS));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(sm.empty + 8 * s),
                 "r"(CTHREADS));
  }
  for (int s = 0; s < Shape<D>::SLICES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(sm.xfull + 8 * s));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar),
               "r"(bytes) : "memory");
}

// Block tiles of this block: blockIdx.x, + gridDim.x, ...
__device__ __forceinline__ long long block_tiles(long long n, int rows) {
  const long long tiles = (n + rows - 1) / rows;
  return tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
}

// The producer: one lane fills the ring, stage after stage (tile, code group,
// slice), each as its slot is released, and copies each x slice of the next
// tile as the last code group's stage of that slice is released.
template <int D>
__device__ __forceinline__ void produce(const Smem<D>& sm, const CUtensorMap* map_x,
                                        const CUtensorMap* map_cb, long long n, int k_codes) {
  using S = Shape<D>;
  const int tiles = (int)block_tiles(n, TILE_ROWS);
  if (tiles == 0) return;
  const int groups = (k_codes + STAGE_CODES - 1) / STAGE_CODES;
  auto load_x = [&](int s, int t) {  // x slice s of the block's tile t
    expect_tx(sm.xfull + 8 * s, S::X_SLICE);
    segsum::tma_load_2d(smem_addr(sm.x + s * TILE_ROWS * DS), map_x, s * DS,
                        (int)((blockIdx.x + (long long)t * gridDim.x) * TILE_ROWS),
                        sm.xfull + 8 * s);
  };
  for (int s = 0; s < S::SLICES; ++s) load_x(s, 0);
  int slot = 0, issued = 0;
  uint32_t phase = 0;
  int rt = 0, rg = 0, rs = 0;  // the stage its slot releases next
  for (int t = 0; t < tiles; ++t)
    for (int g = 0; g < groups; ++g)
      for (int s = 0; s < S::SLICES; ++s) {
        if (issued >= STAGES) {  // the slot's stage is released: every warp searched it
          mbar_wait(sm.empty + 8 * slot, phase ^ 1);
          if (rg == groups - 1 && rt + 1 < tiles) load_x(rs, rt + 1);  // read for the last time
          if (++rs == S::SLICES) {
            rs = 0;
            if (++rg == groups) { rg = 0; ++rt; }
          }
        }
        expect_tx(sm.full + 8 * slot, PLANE);
        segsum::tma_load_2d(smem_addr(sm.hi(slot)), map_cb, s * DS, g * STAGE_CODES,
                            sm.full + 8 * slot);
        ++issued;
        if (++slot == STAGES) { slot = 0; phase ^= 1; }
      }
}

// A consumer thread's share of a stage's split: the fp32 codebook the copy
// left in the hi plane becomes tf32(e) there and tf32(e - hi) in the lo
// plane, in place, a 16-byte chunk at a time (each chunk one thread's).
template <int D>
__device__ __forceinline__ void split_stage(const Smem<D>& sm, int slot, long long j) {
  mbar_wait(sm.full + 8 * slot, (uint32_t)((j / STAGES) & 1));
  constexpr int PER = STAGE_CODES * DS / 4 / CTHREADS;  // 16-byte chunks a thread
  float4* hi = reinterpret_cast<float4*>(sm.hi(slot));
  float4* lo = reinterpret_cast<float4*>(sm.lo(slot));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = consumer_tid() + i * CTHREADS;
    const float4 v = hi[c];
    uint32_t h[4], l[4];
    tf32_split::split(__float_as_uint(v.x), h[0], l[0]);
    tf32_split::split(__float_as_uint(v.y), h[1], l[1]);
    tf32_split::split(__float_as_uint(v.z), h[2], l[2]);
    tf32_split::split(__float_as_uint(v.w), h[3], l[3]);
    hi[c] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lo[c] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the slot's next copy
  mbar_arrive(sm.split + 8 * slot);
}

// One stage's products: the warp's 32 rows (x slice `xs`, [32][DS]) against
// its 64 codes of the stage (`bh`, `bl`: [64][DS] hi and lo), k8 steps 2p and
// 2p + 1 of vq_search.cuh's order: lane (g, t) takes chunk t of each row and
// code, columns 4t + 2s and 4t + 2s + 1 of step s.
__device__ __forceinline__ void stage_products(const float* xs, const float* bh, const float* bl,
                                               int lane, float (&acc)[MT][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float4 u = *reinterpret_cast<const float4*>(xs + (16 * m + g) * DS + 4 * t);
    const float4 v = *reinterpret_cast<const float4*>(xs + (16 * m + g + 8) * DS + 4 * t);
    const float s0[4] = {u.x, v.x, u.y, v.y}, s1[4] = {u.z, v.z, u.w, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tf32_split::split(__float_as_uint(s0[i]), ah[m][0][i], al[m][0][i]);
      tf32_split::split(__float_as_uint(s1[i]), ah[m][1][i], al[m][1][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 h = *reinterpret_cast<const float4*>(bh + (8 * j + g) * DS + 4 * t);
    const float4 l = *reinterpret_cast<const float4*>(bl + (8 * j + g) * DS + 4 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      tf32_split::mma_3xtf32(acc[m][j], ah[m][0], al[m][0], __float_as_uint(h.x),
                             __float_as_uint(h.y), __float_as_uint(l.x), __float_as_uint(l.y));
      tf32_split::mma_3xtf32(acc[m][j], ah[m][1], al[m][1], __float_as_uint(h.z),
                             __float_as_uint(h.w), __float_as_uint(l.z), __float_as_uint(l.w));
    }
  }
}

// The fold of a code group's distances into the lane's best, codes n0 ..
// n0 + 63 (|e|^2 from device memory, +inf past K), in ascending code order.
__device__ __forceinline__ void fold(const float (&acc)[MT][NT][4], const float* __restrict__ e2,
                                     int n0, int k_codes, int lane, float (&best)[MT][2],
                                     int (&arg)[MT][2]) {
  const int t = lane & 3;
  float2 e[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k0 = n0 + 8 * j + 2 * t;  // K is even: k0 < K holds k0 + 1 too
    e[j] = k0 < k_codes ? __ldg(reinterpret_cast<const float2*>(e2 + k0))
                        : make_float2(CUDART_INF_F, CUDART_INF_F);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k0 = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = e[j].x - 2.0f * acc[m][j][2 * h];
        const float d1 = e[j].y - 2.0f * acc[m][j][2 * h + 1];
        if (d0 < best[m][h]) { best[m][h] = d0; arg[m][h] = k0; }
        if (d1 < best[m][h]) { best[m][h] = d1; arg[m][h] = k0 + 1; }
      }
  }
}

// The nearest code of each row of a block tile, for one consumer warp: arg
// as vq_search::search leaves it (row 16m + 8h + g of the warp's slab in quad
// g's arg[m][h]), the codes of both parts of the slab merged. `j` is the
// block's running stage count (0 at its first tile), which the call advances
// by the tile's stages; a warp splits its share of stage j + 1 before it
// searches stage j.
template <int D>
__device__ __forceinline__ void search_tile(const Smem<D>& sm, const float* __restrict__ e2,
                                            int k_codes, long long tile, long long tiles,
                                            long long& j, int (&arg)[MT][2]) {
  using S = Shape<D>;
  const int lane = threadIdx.x & 31, warp = consumer_warp();
  const int rw = warp % SLABS, cw = warp / SLABS;
  const int groups = (k_codes + STAGE_CODES - 1) / STAGE_CODES;
  const long long total = tiles * groups * S::SLICES;
  float best[MT][2];
  vq_search::search_init(best, arg);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < S::SLICES; ++s, ++j) {
      if (j == 0) split_stage(sm, 0, 0);  // the block's first stage
      if (j + 1 < total) split_stage(sm, (int)((j + 1) % STAGES), j + 1);
      const int slot = (int)(j % STAGES);
      mbar_wait(sm.split + 8 * slot, (uint32_t)((j / STAGES) & 1));
      if (g == 0) mbar_wait(sm.xfull + 8 * s, (uint32_t)(tile & 1));
      stage_products(sm.x + (s * TILE_ROWS + 32 * rw) * DS, sm.hi(slot) + 64 * cw * DS,
                     sm.lo(slot) + 64 * cw * DS, lane, acc);
      mbar_arrive(sm.empty + 8 * slot);
    }
    fold(acc, e2, g * STAGE_CODES + 64 * cw, k_codes, lane, best, arg);
  }
  vq_search::search_merge(best, arg);
  {  // the slab's two halves: the smaller dist, then the smaller index
    const int g = lane >> 2;
    if ((lane & 3) == 0)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sm.merge[warp * 32 + 16 * m + 8 * h + g] =
              make_float2(best[m][h], __int_as_float(arg[m][h]));
    asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rw) : "memory");
    const int other = warp ^ SLABS;  // the slab's other half
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 o = sm.merge[other * 32 + 16 * m + 8 * h + g];
        const int oi = __float_as_int(o.y);
        if (o.x < best[m][h] || (o.x == best[m][h] && oi < arg[m][h])) arg[m][h] = oi;
      }
  }
}

// The producer warpgroup's registers to the consumers; the first thread then
// fills the ring. Every thread of the warpgroup calls it.
template <int D>
__device__ __forceinline__ void producer_warpgroup(const Smem<D>& sm, const CUtensorMap* map_x,
                                                   const CUtensorMap* map_cb, long long n,
                                                   int k_codes) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
  if (threadIdx.x == 0) produce(sm, map_x, map_cb, n, k_codes);
  __syncwarp();
}

// The consumer warps take the producer warpgroup's registers. Every consumer
// thread calls it first.
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
}

// Before a launch: a tensor map of x (n, D) in boxes of an x slice and one of
// the codebook (K, D) in boxes of a stage, rows past their ends read as zeros.
template <int D>
inline int maps(const float* x, const float* cb, long long n, int k_codes, CUtensorMap* map_x,
                CUtensorMap* map_cb) {
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint32_t x_box[2] = {(cuuint32_t)DS, (cuuint32_t)TILE_ROWS};
  const cuuint64_t cb_dims[2] = {(cuuint64_t)D, (cuuint64_t)k_codes};
  const cuuint32_t cb_box[2] = {(cuuint32_t)DS, (cuuint32_t)STAGE_CODES};
  if (int e = segsum::encode(map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, x_dims, strides,
                             x_box))
    return e;
  return segsum::encode(map_cb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, cb, cb_dims, strides, cb_box);
}

}  // namespace vq_stream
