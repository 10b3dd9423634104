// The codebook gradient's segment sum, dcb[k] = sum of the rows of g whose id
// is k, as one kernel design for two callers:
// - #5 (vq_fused.cu, vq_codebook_grad): one sum over all 64 columns;
// - #9's split2 gradient (vq_precision.cu, vq_precision_bwd_split2): the sum
//   of bf16(g) and the sum of bf16(g - bf16(g)), each rounded to nearest even
//   in registers, taken apart and added at the end.
//
// Replaces: msla_tpu/ops/vq_fused.py:81 _bwd_kernel (vq_codebook_grad_pallas)
// and tools/bench_vq_precision.py:139 make_bwd("split2").
//
// Bound on an H100 at N = 704,000 rows, K = 512, D = 64: 2.9e7 adds (5.8e7 for
// split2's two sums) on 180.2 MB of g and 2.8 MB of ids, 0.055 ms at 3.35 TB/s:
// bound by the bytes. The design answers what held the earlier kernels (one
// 32-byte slice of a row in each lane's registers, a serial walk over the lanes
// that share a code, and one (K, D) partial per SM summed by a second kernel):
//
// 1. Bytes in flight. Persistent blocks, one an SM, each block on
//    one contiguous run of rows ("part"). Warp 0 is the producer: one lane
//    fills a ring of 3 to 6 stages in shared memory by TMA, a 2-D box of the
//    stage's rows x the block's columns of g (64 rows x 64 columns for #5,
//    128 rows x 32 columns for #9: 16 KB) and a 1-D box of its ids, both
//    completing on the stage's `full` mbarrier. Rows past N arrive as zeros.
//    The block's (K + 1, 64) accumulator takes (K + 1) x 256 B, so 3 stages
//    fit up to K = 701 (#5) and 689 (#9), and K = 512 has 5: 48 to 80 KB in
//    flight per SM. The consumers never hold a load in registers.
// 2. Skew. Warp 1 sorts each 32-row group's keys (code * 32 + lane) with a
//    shuffle bitonic network, so the rows of one code are contiguous and in
//    ascending row order, and writes per sorted position the row's offset in
//    the stage, the code's offset in the accumulator (ids outside [0, K) and
//    rows past the part sort last, to a spare row K) and an end weight, 1 at
//    a segment's last position and 0 elsewhere, with a mask of the segments'
//    starts. Lanes then own columns, not rows: consumer warp (a, q) owns
//    column set a (#5: columns 32a .. 32a + 31; #9: the hi sum (a = 0) or the
//    lo sum (a = 1) of the block's 32 columns), one column a lane, and every
//    W-th group from the q-th (W = 2 for #5, 4 for #9, whose rows carry twice
//    the values: 6 and 10 warps). It walks the 32 sorted positions in order, each a
//    whole 128-byte row slice from shared memory (no bank conflict), with the
//    running sum of the segment in a register (restarted at a segment's
//    start: a left fold in ascending rows), and keeps the sum times the end
//    weight at each position. Then it loads the accumulator at all 32
//    positions, and stores each one's value plus its kept sum, in ascending
//    positions: a segment's last store, the only one that adds, is the one
//    that stays. No predicate and no branch depends on the ids: the time is
//    the same for any ids, one code for every row included. The W warps of a
//    column set take turns on the accumulator in group order (an mbarrier a
//    warp: its turn), so every sum has one fixed order and no float atomics
//    exist anywhere.
// 3. No (K, D) partial per SM. Clusters of 4 blocks: after their streams,
//    block r of a cluster sums its slice of the accumulators of the blocks
//    that share its columns, in part order, through distributed shared
//    memory, and writes it to the cluster's partial. A second kernel, one
//    thread an output, sums the clusters' partials in cluster order (and
//    split2's hi sum and lo sum, then adds them). Scratch: one (K, 64)
//    partial per cluster and column half: 3.9 MB (#5) and 7.9 MB (#9) at
//    K = 512 on an H100 SXM, which runs 30 such clusters at once, against
//    17.3 MB before.
// 4. Wider rows (#5 at D = 128 and 256, the sweep's embedding widths): the
//    same blocks run over D / 64 column slices of 64, as the grid's second
//    dimension. The (K + 1, 64) accumulator is what fits beside the ring, and
//    a column's sum never reads another column, so each slice is the D = 64
//    kernel on its columns: every column keeps its row order, and the result
//    stays bit-equal to the same order's plain version. The wrapper gives
//    each slice 1 / (D / 64) of the clusters that run at once, so that all
//    slices run in one wave; their partials sit slice by slice.
// 5. Any D and K (#5 at the widths of a JAX VQ beyond the sweep's): D need
//    not be a multiple of 64. The last slice's box reaches past D, and TMA
//    reads the columns past D as zeros, which the finish kernel never
//    writes out (g's rows must be 16-byte multiples: the wrapper pads them
//    to 4 columns where D % 4 != 0). K beyond the accumulator (K > 701) runs
//    as launches over runs of codes [code0, code0 + K'), each id taken as id
//    - code0, so that the ids outside the run go to the spare row; every run
//    has the same grid, so each code's sum keeps the one order.
// ops/segment_sum.py codebook_grad_order_ref repeats this order on the plain
// ops: the kernels' results equal it bit for bit at the card's grid.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda's functions are looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr unsigned FULL = 0xffffffffu;
constexpr int D = 64;                   // columns of g a slice (a block's grid row)
constexpr int ACC_COLS = 64;            // floats per code in a block's accumulator
constexpr int CLUSTER = 4;              // blocks a cluster
constexpr int TURNS = 8;                // turn mbarriers: 2 column sets x at most 4 warps
constexpr int MIN_STAGES = 3, MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may use on Hopper
constexpr long long WAIT_NS = 2000000000LL;  // an mbarrier wait longer than this traps

template <bool SPLIT2>
struct Variant;
// #5: a block owns all 64 columns of its part's rows.
template <>
struct Variant<false> {
  static constexpr int HALVES = 1;      // blocks that share a part, one a column half
  static constexpr int COLS = 64;       // columns of g a block loads
  static constexpr int STAGE_ROWS = 64;
  static constexpr int WARPS = 2;       // consumer warps a column set, taking turns
};
// #9 split2: block 2p + h owns columns 32h .. 32h + 31 of part p's rows.
template <>
struct Variant<true> {
  static constexpr int HALVES = 2;
  static constexpr int COLS = 32;
  static constexpr int STAGE_ROWS = 128;
  static constexpr int WARPS = 4;       // twice #5's values a row: the split's two sums
};

template <bool SPLIT2>
struct Layout {
  using V = Variant<SPLIT2>;
  static constexpr int GROUPS = V::STAGE_ROWS / 32;            // 32-row groups a stage
  static constexpr int G_BYTES = V::STAGE_ROWS * V::COLS * 4;  // 16 KB
  static constexpr int SLOT_BYTES = G_BYTES + V::STAGE_ROWS * 4;  // g, then ids
  // a stage: its slot; a group's 32 (row, code) offsets, 32 end weights and
  // its starts mask; 3 mbarriers
  static constexpr int STAGE_BYTES = SLOT_BYTES + GROUPS * (32 * 8 + 32 * 4 + 4) + 3 * 8;
  static_assert(G_BYTES % 128 == 0 && SLOT_BYTES % 128 == 0, "TMA boxes 128-byte aligned");
  static constexpr int THREADS = 64 + 2 * 32 * V::WARPS;  // producer, sorter, consumers
  static_assert(GROUPS % V::WARPS == 0, "the warps of a column set take a stage's groups");
};
// The stages' bytes as ops/segment_sum.py _stage_bytes restates them (the
// port's tests read these two figures).
static_assert(Layout<false>::STAGE_BYTES == 17440, "#5's stage: restate it in Python");
static_assert(Layout<true>::STAGE_BYTES == 18472, "split2's stage: restate it in Python");

// Dynamic shared memory at `stages` stages: the accumulator (K codes and a
// row that takes what ids outside [0, K) would add), the stages, the turn
// mbarriers and 128 bytes to align the base (ops/segment_sum.py smem_bytes).
template <bool SPLIT2>
constexpr size_t smem_bytes(int k_codes, int stages) {
  return (size_t)(k_codes + 1) * ACC_COLS * 4 + (size_t)stages * Layout<SPLIT2>::STAGE_BYTES +
         TURNS * 8 + 128;
}

// The most stages that fit beside K codes, at most MAX_STAGES; fewer than
// MIN_STAGES means K does not fit.
template <bool SPLIT2>
inline int stages_for(int k_codes) {
  const long long free = SMEM_LIMIT - (long long)(k_codes + 1) * ACC_COLS * 4 - TURNS * 8 - 128;
  const long long s = free / Layout<SPLIT2>::STAGE_BYTES;
  return (int)(s < MAX_STAGES ? s : MAX_STAGES);
}

// ---- device helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// A 2-D box at (c0, c1) of the tensor map into shared memory at `dst`,
// completing its bytes on the mbarrier at `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0,
                                            uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2}], [%3];\n"
               :: "r"(dst), "l"(map), "r"(c0), "r"(bar) : "memory");
}

// 16 bytes of block `cta`'s shared memory at the local address `addr`.
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t cta) {
  float4 v;
  asm volatile("{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %4, %5;\n"
               "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [r];\n}\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr), "r"(cta) : "memory");
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The value a consumer sums of g's x: x itself (#5), or split2's hi part
// bf16(x) or lo part bf16(x - bf16(x)).
template <bool SPLIT2>
__device__ __forceinline__ float term(float x, bool lo_part) {
  if (!SPLIT2) return x;
  const float hi = bf16_round(x);
  return lo_part ? bf16_round(x - hi) : hi;
}

// A consumer's walk over one group's 32 sorted positions (`gs`: the lane's
// column of the stage's rows; `ms`, `ws`, `first`: the group's offsets, end
// weights and starts): at each position its code's byte offset in the
// accumulator, and the running sum of its segment so far (restarted at a
// start) times its end weight, 1 at the segment's last position, else 0.
template <bool SPLIT2>
__device__ __forceinline__ void walk(const unsigned char* gs, const int4* ms, const float4* ws,
                                     unsigned first, bool lo_part, float (&add)[32],
                                     int (&at)[32]) {
  float run = 0.f;
#pragma unroll
  for (int p = 0; p < 32; p += 4) {
    const int4 m0 = ms[p / 2], m1 = ms[p / 2 + 1];
    const float4 w = ws[p / 4];
    const int rows[4] = {m0.x, m0.z, m1.x, m1.z};
    const float wt[4] = {w.x, w.y, w.z, w.w};
    at[p] = m0.y;
    at[p + 1] = m0.w;
    at[p + 2] = m1.y;
    at[p + 3] = m1.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = term<SPLIT2>(*reinterpret_cast<const float*>(gs + rows[j]), lo_part);
      run = first >> (p + j) & 1 ? v : run + v;
      add[p + j] = run * wt[j];
    }
  }
}

// Sort each lane's keys across the warp, ascending (a bitonic network).
template <int N>
__device__ __forceinline__ void warp_sort(int (&key)[N], int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool take_min = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int other = __shfl_xor_sync(FULL, key[i], j);
        key[i] = take_min ? min(key[i], other) : max(key[i], other);
      }
    }
}

// The sorter warp's work on one stage (`ids`: its ids, taken less `code0`;
// rows from `row0`, of which those at `end` and past it are not the part's): each 32-row group's
// keys sorted, and per sorted position the row's byte offset in the stage's
// g and its code's in the accumulator (`out`), its end weight (`weights`),
// and the group's mask of segment starts (`starts`).
template <bool SPLIT2>
__device__ __forceinline__ void sort_stage(const int* ids, long long row0, long long end,
                                           int code0, int k_codes, int* out, float* weights,
                                           unsigned* starts, int lane) {
  constexpr int GROUPS = Layout<SPLIT2>::GROUPS, COLS = Variant<SPLIT2>::COLS;
  int key[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int r = 32 * g + lane;
    const int code = ids[r] - code0;
    const bool ok = row0 + r < end && (unsigned)code < (unsigned)k_codes;
    key[g] = (ok ? code : k_codes) << 5 | lane;  // invalid rows sort last, never end
  }
  warp_sort(key, lane);
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int code = key[g] >> 5;  // k_codes: the spare row
    const int prev = __shfl_up_sync(FULL, code, 1), next = __shfl_down_sync(FULL, code, 1);
    const unsigned first = __ballot_sync(FULL, lane == 0 || prev != code);
    out[(32 * g + lane) * 2] = (32 * g + (key[g] & 31)) * COLS * 4;
    out[(32 * g + lane) * 2 + 1] = code * ACC_COLS * 4;
    weights[g * 32 + lane] = lane == 31 || next != code ? 1.f : 0.f;
    if (lane == 0) starts[g] = first;
  }
}

// A consumer lane's adds of one group into its column of the accumulator:
// every position adds to its code's row, in ascending positions, so a
// segment's last add, the only one of weight 1, is its last store; every
// load comes before the first store.
__device__ __forceinline__ void add_group(unsigned char* acc_lane, const int (&at)[32],
                                          const float (&add)[32]) {
  float old[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) old[p] = *reinterpret_cast<const float*>(acc_lane + at[p]);
#pragma unroll
  for (int p = 0; p < 32; ++p) *reinterpret_cast<float*>(acc_lane + at[p]) = old[p] + add[p];
}

// ---- the kernels ----------------------------------------------------------------

// Block (b, y) takes the rows [part * rows_per_part, ...) of part b / HALVES
// and the columns of half b % HALVES of column slice y (64 y .. 64 y + 63);
// partials is [slices][clusters][HALVES][K][64].
template <bool SPLIT2>
__global__ void __launch_bounds__(Layout<SPLIT2>::THREADS, 1)
segment_sum_kernel(const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_ids, float* __restrict__ partials,
                   long long n, int code0, int k_codes, long long rows_per_part,
                   int stages) {
  using V = Variant<SPLIT2>;
  using L = Layout<SPLIT2>;
  constexpr int GROUPS = L::GROUPS, THREADS = L::THREADS, W = V::WARPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  float* acc = reinterpret_cast<float*>(base);                          // [K + 1][64]
  unsigned char* ring = base + (size_t)(k_codes + 1) * ACC_COLS * 4;    // [S][g | ids]
  int4* meta = reinterpret_cast<int4*>(ring + (size_t)stages * L::SLOT_BYTES);  // [S][G][16]
  float* weights = reinterpret_cast<float*>(meta + stages * GROUPS * 16);        // [S][G][32]
  unsigned* starts = reinterpret_cast<unsigned*>(weights + stages * GROUPS * 32);  // [S][G]
  const uint32_t full = smem_addr(starts + stages * GROUPS);  // [S] mbarriers, then sorted, empty
  const uint32_t sorted = full + 8 * stages, empty = sorted + 8 * stages;
  const uint32_t turn = empty + 8 * stages;  // [2 column sets][W]: the turn to warp q

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = blockIdx.x % V::HALVES;
  const long long begin = (long long)(blockIdx.x / V::HALVES) * rows_per_part;
  const long long end = begin + rows_per_part < n ? begin + rows_per_part : n;
  const int n_stages = begin < end ? (int)((end - begin + V::STAGE_ROWS - 1) / V::STAGE_ROWS) : 0;

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = tid; i < (k_codes + 1) * ACC_COLS / 4; i += THREADS)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(full + 8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" :: "r"(sorted + 8 * s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(empty + 8 * s), "r"(THREADS - 64));
    }
    for (int i = 0; i < 2 * W; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" :: "r"(turn + 8 * i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // producer: one lane issues every copy
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_stages; ++i) {
        mbar_wait(empty + 8 * s, phase ^ 1);  // a fresh stage is free
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(full + 8 * s), "r"(L::SLOT_BYTES) : "memory");
        const uint32_t slot = smem_addr(ring + (size_t)s * L::SLOT_BYTES);
        const int row0 = (int)(begin + (long long)i * V::STAGE_ROWS);
        tma_load_2d(slot, &map_g, (int)blockIdx.y * D + half * V::COLS, row0, full + 8 * s);
        tma_load_1d(slot + L::G_BYTES, &map_ids, row0, full + 8 * s);
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
  } else if (warp == 1) {  // sorter: each group's order, offsets, end weights and starts
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_stages; ++i) {
      mbar_wait(full + 8 * s, phase);
      sort_stage<SPLIT2>(
          reinterpret_cast<const int*>(ring + (size_t)s * L::SLOT_BYTES + L::G_BYTES),
          begin + (long long)i * V::STAGE_ROWS, end, code0, k_codes,
          reinterpret_cast<int*>(meta + (size_t)s * GROUPS * 16), weights + s * GROUPS * 32,
          starts + s * GROUPS, lane);
      mbar_arrive(sorted + 8 * s);
      if (++s == stages) { s = 0; phase ^= 1; }
    }
  } else {  // consumer (a, q): column set a, the groups gidx with gidx % W = q
    const int cw = warp - 2, a = cw & 1, q = cw >> 1;
    const bool lo_part = SPLIT2 && a == 1;
    const int col = SPLIT2 ? lane : 32 * a + lane;  // the lane's column of a stage row
    unsigned char* acc_lane = reinterpret_cast<unsigned char*>(acc + 32 * a + lane);
    const uint32_t wait_turn = turn + 8 * (W * a + q), give_turn = turn + 8 * (W * a + (q + 1) % W);
    const int total_groups = n_stages * GROUPS;
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_stages; ++i) {
      mbar_wait(full + 8 * s, phase);
      mbar_wait(sorted + 8 * s, phase);
      const unsigned char* gs = ring + (size_t)s * L::SLOT_BYTES + col * 4;
#pragma unroll 1
      for (int g = q; g < GROUPS; g += W) {
        const int4* ms = meta + ((size_t)s * GROUPS + g) * 16;
        const float4* ws = reinterpret_cast<const float4*>(weights + (s * GROUPS + g) * 32);
        const unsigned first = starts[s * GROUPS + g];
        float add[32];
        int at[32];
        walk<SPLIT2>(gs, ms, ws, first, lo_part, add, at);
        if (g + W >= GROUPS) mbar_arrive(empty + 8 * s);  // the stage is read
        const int gidx = i * GROUPS + g;  // once group gidx - 1 is added, by warp q - 1
        if (gidx > 0) mbar_wait(wait_turn, ((gidx - 1) / W) & 1);
        add_group(acc_lane, at, add);
        if (gidx + 1 < total_groups) mbar_arrive(give_turn);  // releases this warp's stores
      }
      if (++s == stages) { s = 0; phase ^= 1; }
    }
  }

  // The cluster's accumulators of one column half, summed in part order:
  // block r sums slice r / HALVES of those of half r % HALVES.
  cluster_sync();
  constexpr int PER = CLUSTER / V::HALVES;  // blocks of one half in a cluster
  const uint32_t rank = cluster_rank();
  const int h = rank % V::HALVES, slice = rank / V::HALVES;
  const int e4 = k_codes * ACC_COLS / 4;  // the spare row is left out
  const size_t cluster = (size_t)blockIdx.y * (gridDim.x / CLUSTER) + cluster_id();
  float4* out = reinterpret_cast<float4*>(partials) + (cluster * V::HALVES + h) * e4;
  const uint32_t acc_addr = smem_addr(acc);
  for (int i = e4 * slice / PER + tid; i < e4 * (slice + 1) / PER; i += THREADS) {
    float4 sum = ld_cluster(acc_addr + 16 * i, h);
#pragma unroll
    for (int t = 1; t < PER; ++t) {
      const float4 v = ld_cluster(acc_addr + 16 * i, h + t * V::HALVES);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    out[i] = sum;
  }
  cluster_sync();  // no block leaves while another may still read its accumulator
}

// dcb[k][c] (K, d) from the clusters' partials, summed in cluster order;
// split2 (d = 64): the hi sum plus the lo sum.
template <int HALVES>
__global__ void segment_sum_finish(const float* __restrict__ partials, int clusters, int k_codes,
                                   int d, float* __restrict__ dcb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // k * d + c
  const int e = k_codes * ACC_COLS;
  if (i >= k_codes * d) return;
  if (HALVES == 1) {
    const int k = i / d, c = i % d;  // column c % 64 of slice c / 64
    const float* p = partials + (size_t)(c / D) * clusters * e + (size_t)k * ACC_COLS + c % D;
    float s = p[0];
    for (int cl = 1; cl < clusters; ++cl) s += p[(size_t)cl * e];
    dcb[i] = s;
  } else {
    const int k = i / D, c = i % D, h = c / 32;
    const size_t o = (size_t)h * e + (size_t)k * ACC_COLS + c % 32;
    float hi = partials[o], lo = partials[o + 32];
    for (int p = 1; p < clusters; ++p) {
      hi += partials[(size_t)p * HALVES * e + o];
      lo += partials[(size_t)p * HALVES * e + o + 32];
    }
    dcb[i] = hi + lo;
  }
}

// ---- host side --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of `rank` dims (innermost first), read in boxes of `box`, with
// no swizzle and positions past its end read as zeros. cuTensorMapEncodeTiled
// lives in libcuda: it is looked up through cudaGetDriverEntryPoint, so the
// library links against the runtime alone.
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* p,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
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
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(p), dims, strides, box,
                        step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool SPLIT2>
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int clusters, int k_codes,
                                        cudaStream_t s, int slices = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * CLUSTER), (unsigned)slices, 1);
  cfg.blockDim = dim3(Layout<SPLIT2>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<SPLIT2>(k_codes, stages_for<SPLIT2>(k_codes));
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool SPLIT2>
inline int allow_smem(int k_codes) {
  if (k_codes < 1 || stages_for<SPLIT2>(k_codes) < MIN_STAGES) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      segment_sum_kernel<SPLIT2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<SPLIT2>(k_codes, stages_for<SPLIT2>(k_codes)));
}

// The most clusters of the kernel at K codes the card runs at once: the
// wrapper's grid (ops/segment_sum.py layout).
template <bool SPLIT2>
inline int max_clusters(int k_codes, int* clusters) {
  if (int e = allow_smem<SPLIT2>(k_codes)) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<SPLIT2>(&attr, 1, k_codes, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)segment_sum_kernel<SPLIT2>,
                                             &cfg);
}

// g (n, d) fp32, d a multiple of 4 (64 for split2), and idx (n,) int32,
// both 16-byte aligned; dcb (K, d) the output, the sums of codes code0 ..
// code0 + K - 1; partials (ceil(d / 64), clusters, HALVES, K, 64) scratch;
// `clusters` a column slice. Two launches: the segment sum, then the
// clusters' partials summed into dcb.
template <bool SPLIT2>
inline int launch(const float* g, const int* idx, float* dcb, float* partials, int clusters,
                  long long rows_per_part, long long n, int k_codes, cudaStream_t s,
                  int d = D, int code0 = 0) {
  using V = Variant<SPLIT2>;
  if (n <= 0) return (int)cudaMemsetAsync(dcb, 0, (size_t)k_codes * d * sizeof(float), s);
  if (clusters < 1 || rows_per_part % V::STAGE_ROWS ||
      rows_per_part * clusters * (CLUSTER / V::HALVES) < n || d < 4 || d % 4 ||
      (SPLIT2 && d != D))
    return (int)cudaErrorInvalidValue;
  const int slices = (d + D - 1) / D;
  if (int e = allow_smem<SPLIT2>(k_codes)) return e;
  CUtensorMap map_g, map_ids;  // g's pointer changes from call to call: encoded each call
  const cuuint64_t g_dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t g_strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t g_box[2] = {(cuuint32_t)V::COLS, (cuuint32_t)V::STAGE_ROWS};
  const cuuint64_t id_dims[1] = {(cuuint64_t)n};
  const cuuint32_t id_box[1] = {(cuuint32_t)V::STAGE_ROWS};
  int status = encode(&map_g, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, g, g_dims, g_strides, g_box);
  if (status == 0)
    status = encode(&map_ids, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, idx, id_dims, g_strides, id_box);
  if (status != 0) return status;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<SPLIT2>(&attr, clusters, k_codes, s, slices);
  cudaError_t err = cudaLaunchKernelEx(&cfg, segment_sum_kernel<SPLIT2>, map_g, map_ids, partials,
                                       n, code0, k_codes, rows_per_part,
                                       stages_for<SPLIT2>(k_codes));
  if (err != cudaSuccess) return (int)err;
  const int e = k_codes * d;
  segment_sum_finish<V::HALVES><<<(e + 255) / 256, 256, 0, s>>>(partials, clusters, k_codes, d,
                                                                dcb);
  return (int)cudaGetLastError();
}

}  // namespace segsum
