// The L2 nearest-code search of the port's fp32 VQ kernels: nearest_codes.cu
// (K3), vq_fused.cu (#4's forward) and vq_lean.cu (#8). Per row, argmin over
// k of dist = |e_k|^2 - 2 x . e_k (|x|^2 is constant per row and dropped),
// the first index among equal minima, as the TPU kernels' `dist <= m` then
// least iota.
//
// Bound on an H100: at N = 704,000 rows, K = 512, D = 64 the search is a GEMM
// of 2*N*K*D = 4.61e10 FLOP: 0.093 ms at the TF32 tensor-core peak (495
// TFLOP/s), 0.279 ms for the three products of 3xTF32, 0.689 ms on the fp32
// FMA units (67 TFLOP/s), where the first designs of all three kernels
// searched. K3 must move 180.2 MB in + 2.8 MB out: 0.055 ms at 3.35 TB/s.
// No kernel of the port searches codes on the FMA units any more. So the
// distances run on the tensor cores, in
// 3xTF32 (tf32_split.cuh: mma.sync.m16n8k8 on hi = tf32(v) and lo = tf32(v -
// hi), lo.hi + hi.lo + hi.hi a k8 step into one fp32 accumulator), not one
// TF32 pass, which keeps ~11 bits of each product and flips near-ties.
//
// Design (one block of 8 warps an SM, persistent; a warp takes tiles of 32
// rows, the warp's tile `+= warps in the grid`):
// - The codebook (fp32) and |e|^2 sit in shared memory for the block's life;
//   codes past K, up to a multiple of 32, are zero rows with |e|^2 = +inf, so
//   their dist is +inf and never wins. Each warp has its own 32-row x tile in
//   shared memory, which cp.async fills (rows past N zero-filled).
// - The warp's tile is two m16 tiles (rows) against all codes, 4 n8 tiles (32
//   codes) at a time, in ascending code order. The depth runs in D/16 pairs
//   of k8 steps; a lane holds one 16-byte chunk of each pair (columns 16p + 4t
//   .. 16p + 4t + 3), which gives both steps' A fragments of a row (and both
//   steps' B fragments of a code) by one 16-byte load: step 2p + s takes
//   columns 16p + 4t + 2s (as the fragment's column t) and + 1 (column t + 4).
//   The same bijection on A and B: the k8 steps add the same 64 products,
//   grouped in another order.
// - Shared-memory rows are unpadded (D floats) and swizzled: chunk c of row r
//   lies at chunk c ^ 4 (r & 1), so the 8 lanes of a quarter warp (rows g of
//   one parity each, t = 0..3) read 8 distinct bank groups. The codebook
//   (128 KB), |e|^2 (2 KB) and the 8 x tiles (64 KB) take 194 KB at K = 512.
// - Registers: the split is the cost the tensor cores do not pay, so each
//   split serves every product that reuses it. A warp splits its rows' A
//   fragments once a tile and holds them (2 m-tiles x 8 k-steps x 4, hi and
//   lo: 128 registers at D = 64), then loads and splits each B fragment once
//   for both m-tiles. The other orientation, the codebook's split fragments
//   held in registers, needs 2 x 128 KB at K = 512: the whole register file.
//   Held A frees the x tile as soon as it is split, so the next tile's
//   cp.async runs under the whole search. kHoldA<D> = false streams the A
//   fragments from the x tile instead, split again for each group of 4
//   n-tiles (at D >= 128, where 2 m-tiles would hold 256+ registers,
//   vq_stream.cuh streams them for each 64 codes), and at D = 64 the
//   alternative measured (tools/bench_stems.py, "A streamed";
//   PERF.md): it splits twice as much and takes K3 and #4 about a tenth
//   longer, so D = 64 holds A. ptxas: 239 registers for K3, 218 for #4, no
//   spills (#8's in PERF.md); one block of 8 warps an SM (the codebook fills
//   its shared memory). The same tool puts the time in the tensor cores'
//   products: with one product instead of three K3 takes under half its
//   time, and without the split's arithmetic it is no faster.
// - The argmin folds in registers: a lane holds columns 2t, 2t + 1 of each
//   n8 tile for rows g and g + 8, walks them in ascending code order with a
//   strict <, then merges over its quad as (dist, index) pairs, the smaller
//   dist and, on an equal dist, the smaller index. The (N, K) distances never
//   leave registers.
// - dist = |e|^2 - 2 acc in fp32, as the plain version and the TPU kernel
//   write it (|e|^2 from the wrapper's code_norms).
// D is a compile-time parameter (a multiple of 32). The design above is
// built at D = 64, the default embedding width. At D = 128 and 256 (the
// sweep's embedding widths) the codebook does not fit beside the x tiles:
// vq_stream.cuh streams it through a ring of stages, with this file's k8
// steps, 3xTF32 products, fold rule and quad merge.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace vq_search {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 32;            // rows of a warp tile: two m16 tiles
constexpr int MT = 2;
constexpr int NT = 4;               // n8 tiles a group
constexpr int GROUP = 8 * NT;       // codes a group; K is padded to a multiple

// whether a warp holds its rows' split A fragments for the tile (else it
// loads and splits them from the x tile for each group)
template <int D>
constexpr bool kHoldA = D <= 64;

__host__ __device__ constexpr int padded_codes(int k) { return (k + GROUP - 1) / GROUP * GROUP; }

// shared memory: codebook [kpad][D], |e|^2 [kpad], x tiles [WARPS][ROWS][D],
// then (#4) a histogram [kpad] int
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int k_codes, bool with_hist) {
  return ((size_t)padded_codes(k_codes) * (D + 1 + (with_hist ? 1 : 0)) +
          (size_t)WARPS * ROWS * D) * sizeof(float);
}

// the 16-byte chunk of row r that holds the row's chunk c
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 1) << 2); }

__device__ __forceinline__ float4 chunk(const float* rows, int r, int c, int d) {
  return *reinterpret_cast<const float4*>(rows + r * d + 4 * swz(r, c));
}

// The codebook and |e|^2 into shared memory, zero rows and +inf past K. Every
// thread of the block calls it; a __syncthreads must follow.
template <int D>
__device__ __forceinline__ void load_codebook(float* es, float* e2s, const float* __restrict__ cb,
                                              const float* __restrict__ e2, int k_codes) {
  constexpr int CHUNKS = D / 4;
  const int kpad = padded_codes(k_codes);
  const float4* cb4 = reinterpret_cast<const float4*>(cb);
  for (int i = threadIdx.x; i < kpad * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    *reinterpret_cast<float4*>(es + r * D + 4 * swz(r, c)) =
        r < k_codes ? cb4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < kpad; i += blockDim.x) e2s[i] = i < k_codes ? e2[i] : CUDART_INF_F;
}

// Start the copy of rows row0 .. row0 + 31 of x into a warp's tile (rows past
// n as zeros) and commit it. Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void load_tile(float* xs, const float* __restrict__ x, long long row0,
                                          long long n, int lane) {
  constexpr int CHUNKS = D / 4;
#pragma unroll
  for (int i = lane; i < ROWS * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const long long row = row0 + r;
    const bool valid = row < n;
    const float* src = x + (valid ? row * D + 4 * c : 0);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(xs + r * D + 4 * swz(r, c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for the warp's tile copy; the tile is then readable by every lane.
__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// m-tile m's A fragments of k8 steps 2p and 2p + 1, split: rows 16m + g and
// 16m + g + 8, each one 16-byte chunk (columns 16p + 4t ..).
template <int D>
__device__ __forceinline__ void load_a(const float* xs, int m, int p, int lane,
                                       uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
  const int g = lane >> 2, t = lane & 3, r = 16 * m + g;
  const float4 u = chunk(xs, r, 4 * p + t, D), v = chunk(xs, r + 8, 4 * p + t, D);
  const float s0[4] = {u.x, v.x, u.y, v.y}, s1[4] = {u.z, v.z, u.w, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tf32_split::split(__float_as_uint(s0[i]), hi[0][i], lo[0][i]);
    tf32_split::split(__float_as_uint(s1[i]), hi[1][i], lo[1][i]);
  }
}

// A warp's A fragments: held for the tile (kHoldA) or loaded as they are used.
template <int D, bool HOLD = kHoldA<D>>
struct RowFrags {
  uint32_t hi[MT][D / 16][2][4], lo[MT][D / 16][2][4];
  __device__ __forceinline__ void load(const float* xs, int lane) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int p = 0; p < D / 16; ++p) load_a<D>(xs, m, p, lane, hi[m][p], lo[m][p]);
  }
  __device__ __forceinline__ void get(const float*, int m, int p, int, uint32_t (&h)[2][4],
                                      uint32_t (&l)[2][4]) const {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[s][i] = hi[m][p][s][i];
        l[s][i] = lo[m][p][s][i];
      }
  }
};

template <int D>
struct RowFrags<D, false> {
  __device__ __forceinline__ void load(const float*, int) {}
  __device__ __forceinline__ void get(const float* xs, int m, int p, int lane,
                                      uint32_t (&h)[2][4], uint32_t (&l)[2][4]) const {
    load_a<D>(xs, m, p, lane, h, l);
  }
};

// Start of a search: no code yet, at +inf.
__device__ __forceinline__ void search_init(float (&best)[MT][2], int (&arg)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[m][h] = CUDART_INF_F;
      arg[m][h] = 0;
    }
}

// One group of 32 codes n0 .. n0 + 31 against the warp's rows: `eg` holds the
// group's codebook rows (row r: code n0 + r, swizzled by r's parity) and
// `e2g` their |e|^2; a lane's best (dist, index) of its columns so far.
template <int D, bool HOLD>
__device__ __forceinline__ void search_group(const RowFrags<D, HOLD>& a, const float* xs,
                                             const float* eg, const float* e2g, int n0, int lane,
                                             float (&best)[MT][2], int (&arg)[MT][2]) {
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) a.get(xs, m, p, lane, ah[m], al[m]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 e = chunk(eg, 8 * j + g, 4 * p + t, D);
      uint32_t bh[4], bl[4];
      tf32_split::split(__float_as_uint(e.x), bh[0], bl[0]);
      tf32_split::split(__float_as_uint(e.y), bh[1], bl[1]);
      tf32_split::split(__float_as_uint(e.z), bh[2], bl[2]);
      tf32_split::split(__float_as_uint(e.w), bh[3], bl[3]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        tf32_split::mma_3xtf32(acc[m][j], ah[m][0], al[m][0], bh[0], bh[1], bl[0], bl[1]);
        tf32_split::mma_3xtf32(acc[m][j], ah[m][1], al[m][1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
  // fold: C holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k0 = n0 + 8 * j + 2 * t;
    const float2 e2 = *reinterpret_cast<const float2*>(e2g + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = e2.x - 2.0f * acc[m][j][2 * h];
        const float d1 = e2.y - 2.0f * acc[m][j][2 * h + 1];
        if (d0 < best[m][h]) { best[m][h] = d0; arg[m][h] = k0; }
        if (d1 < best[m][h]) { best[m][h] = d1; arg[m][h] = k0 + 1; }
      }
  }
}

// End of a search: merge over the quad, the smaller dist, on an equal dist
// the smaller index.
__device__ __forceinline__ void search_merge(float (&best)[MT][2], int (&arg)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(FULL, best[m][h], off);
        const int oi = __shfl_xor_sync(FULL, arg[m][h], off);
        if (od < best[m][h] || (od == best[m][h] && oi < arg[m][h])) {
          best[m][h] = od;
          arg[m][h] = oi;
        }
      }
}

// The nearest code of each of the warp's 32 rows: arg[m][h] for row 16m + 8h
// + g, the same in the quad's four lanes. kpad = padded_codes(K).
template <int D, bool HOLD>
__device__ __forceinline__ void search(const RowFrags<D, HOLD>& a, const float* xs,
                                       const float* es, const float* e2s, int kpad, int lane,
                                       int (&arg)[MT][2]) {
  float best[MT][2];
  search_init(best, arg);
#pragma unroll 1
  for (int n0 = 0; n0 < kpad; n0 += GROUP)
    search_group(a, xs, es + (size_t)n0 * D, e2s + n0, n0, lane, best, arg);
  search_merge(best, arg);
}

// Row `lane`'s code (row 16m + 8h + g sits in quad g's arg[m][h]).
__device__ __forceinline__ int code_of_lane(const int (&arg)[MT][2], int lane) {
  int code = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = __shfl_sync(FULL, arg[m][h], 4 * (lane & 7));
      if ((lane >> 3) == 2 * m + h) code = v;
    }
  return code;
}

}  // namespace vq_search
