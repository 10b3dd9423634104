// The nearest-code search of K3 and #4's forward at any width: idx[n] =
// argmin_k (|e_k|^2 - 2 x_n . e_k), the lowest index on ties; #4 also
// writes q = codebook[idx], the per-code counts and sum |q - x|^2.
//
// Replaces, at the (D, K) nearest_codes.cu and vq_fused.cu are not compiled
// for: msla_tpu/ops/vq_pallas.py:40 _nearest_codes_kernel (K3) and
// msla_tpu/ops/vq_fused.py:42 _fwd_kernel (#4). The JAX VQ runs at any
// embedding_dim D and num_embedding K (msla_tpu/ops/vq.py:137-155); the tuned
// kernels hold the codebook in shared memory at D = 64 (K up to 640) or
// stream it through a TMA ring at D = 128 and 256 (vq_stream.cuh).
//
// The function is vq_search.cuh's: 3xTF32 on mma.sync.m16n8k8 (lo.hi, hi.lo,
// hi.hi a k8 step into one fp32 accumulator, the depth's k8 steps in
// ascending order), dist = |e|^2 - 2 acc in fp32 with |e|^2 from the
// wrapper's code_norms, a strict < fold in ascending code order, then the
// smaller index on an equal dist where two lanes' or warps' bests meet.
// The design:
// - D runs padded to the k8 step (DP = D rounded up to 8): the copies into
//   shared memory fill columns D .. DP - 1 with zeros, which add exact
//   zeros to x . e. Codes past K in the last chunk are zero rows with
//   |e|^2 = +inf: their dist is +inf and never wins the strict <; a warp
//   skips its n8 tiles that hold no code below K, so at most 7 padded codes
//   are searched.
// - A persistent block (one an SM, at most one a tile) takes tiles of ROWS
//   rows of x in shared memory, and streams the codebook through two
//   shared-memory chunks of CODES codes by cp.async, the next chunk's copy
//   under this chunk's products. ROWS and CODES follow D (ops/nearest_codes.py
//   plan_search): 128 rows and 64 codes up to DP = 128, 64 and 64 up to 256,
//   32 and 32 up to 512, so that x's tile and the two chunks fit in a block.
// - Warp w takes the m16 row tile w % (ROWS / 16) and its share of each
//   chunk's codes; its lanes keep each row's best (dist, index) in
//   registers, merged over a quad by shuffles and over the warps of a row
//   tile through shared memory.
// - #4: q and sum |q - x|^2 from the tile's ids after the search (q from
//   device memory, x from shared memory), the squared differences summed in
//   fp64 a thread and reduced in a fixed order (vq_common.cuh), the counts as
//   integer atomics in device memory (no histogram in shared memory, so any
//   K fits): the same bits run after run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_split.cuh"
#include "vq_common.cuh"

namespace {

using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Dynamic shared memory at width d, ROWS rows and CODES codes: x's tile
// [ROWS][DP + 4], two codebook chunks [2][CODES][DP + 4], their |e|^2
// [2][CODES], the warps' bests [8][16] (dist, index) and the tile's ids.
__host__ __device__ constexpr size_t any_smem(int d, int rows, int codes) {
  const size_t ld = round_up(d, 8) + 4;
  return (size_t)rows * ld * 4 + 2 * (size_t)codes * ld * 4 + 2 * (size_t)codes * 4 +
         WARPS * 16 * 8 + (size_t)rows * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [r0, r0 + count) of a (limit, d) fp32 matrix into dst [count][ld],
// columns 0 .. dp - 1, by cp.async; rows past `limit` and columns past d are
// zeros. 16-byte copies where d % 4 == 0 and the source is 16-byte aligned.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, long long r0,
                                          int count, long long limit, int d, int dp, bool vec) {
  if (vec) {
    const int q4 = dp / 4;
    for (int i = threadIdx.x; i < count * q4; i += THREADS) {
      const int r = i / q4, c = 4 * (i % q4);
      const bool valid = r0 + r < limit && c < d;
      const float* s = valid ? src + (r0 + r) * d + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * ld + c)),
                   "l"(s), "r"(valid ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < count * dp; i += THREADS) {
      const int r = i / dp, c = i % dp;
      const bool valid = r0 + r < limit && c < d;
      const float* s = valid ? src + (r0 + r) * d + c : src;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + r * ld + c)),
                   "l"(s), "r"(valid ? 4 : 0));
    }
  }
}

// (da, ia) replaced by (db, ib) where db is smaller, or equal with a smaller index.
__device__ __forceinline__ void take_min(float& da, int& ia, float db, int ib) {
  if (db < da || (db == da && ib < ia)) {
    da = db;
    ia = ib;
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
vq_any_kernel(const float* __restrict__ x, const float* __restrict__ cb,
              const float* __restrict__ e2, int* __restrict__ idx, float* __restrict__ q,
              int* __restrict__ counts_i, double* __restrict__ sq_part, long long n,
              int k_codes, int d, int rows, int codes) {
  const int dp = round_up(d, 8), ld = dp + 4;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);            // [rows][ld]
  float* es = xs + (size_t)rows * ld;                     // [2][codes][ld]
  float* e2s = es + 2 * (size_t)codes * ld;               // [2][codes]
  float2* merge = reinterpret_cast<float2*>(e2s + 2 * codes);  // [WARPS][16]
  int* ids = reinterpret_cast<int*>(merge + WARPS * 16);  // [rows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mtb = rows / 16, per_code = codes / 8 / (WARPS / mtb);  // n8 tiles a warp
  const int mt = warp % mtb, wq = warp / mtb;
  const long long tiles = (n + rows - 1) / rows;
  const int chunks = (k_codes + codes - 1) / codes;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  const float inf = __int_as_float(0x7f800000);

  auto load_chunk = [&](int c) {
    const int buf = c & 1, k0 = c * codes;
    copy_rows(es + (size_t)buf * codes * ld, ld, cb, k0, codes, k_codes, d, dp, vec);
    for (int j = tid; j < codes; j += THREADS)
      e2s[buf * codes + j] = k0 + j < k_codes ? e2[k0 + j] : inf;
  };

  double sq = 0.0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * rows;
    __syncthreads();  // the previous tile's readers of xs, es and ids are done
    copy_rows(xs, ld, x, r0, rows, n, d, dp, vec);
    load_chunk(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    float best[2] = {inf, inf};  // rows 16 mt + g and + 8
    int arg[2] = {0, 0};
    const float* xa = xs + (16 * mt + g) * ld;
    const float* xb = xa + 8 * ld;
    for (int c = 0; c < chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < chunks) load_chunk(c + 1);  // into the buffer chunk c - 1 left
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk c (and x) are in
      __syncthreads();
      float acc[8][4] = {};
      const float* eb = es + ((size_t)buf * codes + wq * per_code * 8 + g) * ld;
      // the warp's n8 tiles that hold a code below K (the rest add nothing)
      const int tiles8 = min(per_code, (k_codes - c * codes - wq * per_code * 8 + 7) / 8);
      for (int k0 = 0; k0 < dp; k0 += 8) {
        const float a[4] = {xa[k0 + t], xb[k0 + t], xa[k0 + t + 4], xb[k0 + t + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__float_as_uint(a[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < tiles8) {
            uint32_t bh0, bl0, bh1, bl1;
            split(__float_as_uint(eb[j * 8 * ld + k0 + t]), bh0, bl0);
            split(__float_as_uint(eb[j * 8 * ld + k0 + t + 4]), bh1, bl1);
            mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
          }
      }
      // fold: the lane's codes 2t, 2t + 1 of each n8 tile, ascending
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < tiles8)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int local = (wq * per_code + j) * 8 + 2 * t + e;
            const float ev = e2s[buf * codes + local];
            const int code = c * codes + local;
            const float d0 = ev - 2.f * acc[j][e], d1 = ev - 2.f * acc[j][2 + e];
            if (d0 < best[0]) {
              best[0] = d0;
              arg[0] = code;
            }
            if (d1 < best[1]) {
              best[1] = d1;
              arg[1] = code;
            }
          }
      __syncthreads();  // every warp is done with this buffer before it refills
    }

    // merge over the quad, then over the warps of a row tile
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        take_min(best[r], arg[r], __shfl_xor_sync(FULL, best[r], off),
                 __shfl_xor_sync(FULL, arg[r], off));
    if (t == 0) {
      merge[warp * 16 + g] = make_float2(best[0], __int_as_float(arg[0]));
      merge[warp * 16 + g + 8] = make_float2(best[1], __int_as_float(arg[1]));
    }
    __syncthreads();
    if (tid < rows) {
      const int m = tid / 16, rl = tid % 16;
      float2 v = merge[m * 16 + rl];
      float bd = v.x;
      int ba = __float_as_int(v.y);
      for (int w = m + mtb; w < WARPS; w += mtb) {
        v = merge[w * 16 + rl];
        take_min(bd, ba, v.x, __float_as_int(v.y));
      }
      ids[tid] = ba;
      if (r0 + tid < n) idx[r0 + tid] = ba;
    }
    if constexpr (FUSED) {
      __syncthreads();
      for (int base = 0; base < rows; base += THREADS) {  // every lane of a warp counts
        const int r = base + tid;
        const bool valid = r < rows && r0 + r < n;
        vq_common::count(counts_i, valid ? ids[r] : 0, valid, lane);
      }
      for (int e = tid; e < rows * d; e += THREADS) {
        const int r = e / d, col = e % d;
        if (r0 + r < n) {
          const float v = cb[(size_t)ids[r] * d + col];
          q[(r0 + r) * d + col] = v;
          const float diff = v - xs[r * ld + col];
          sq += (double)diff * (double)diff;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if constexpr (FUSED) vq_common::flush_block<THREADS>(sq, nullptr, counts_i, sq_part, 0);
}

}  // namespace

// x (n, d) and the codebook (k_codes, d) fp32, any d in 1 .. 512 and any K;
// e2 (K,) their |e|^2; idx (n,) int32. With q null, K3: the ids alone. With
// q (n, d), #4's forward: counts (K,) fp32, sq () fp32, counts_i (K,) int32
// and sq_part (max_parts,) fp64 scratch, as vq_fused_fwd takes them. rows /
// codes: ROWS and CODES (ops/nearest_codes.py plan_search).
extern "C" int vq_any_fwd(const float* x, const float* cb, const float* e2, float* q, int* idx,
                          float* counts, float* sq, int* counts_i, double* sq_part,
                          int max_parts, long long n, int k_codes, int d, int rows, int codes,
                          void* stream) {
  if (d < 1 || k_codes < 1 || (rows != 32 && rows != 64 && rows != 128) ||
      (codes != 32 && codes != 64) || codes / 8 < WARPS / (rows / 16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = any_smem(d, rows, codes);
  const long long tiles = (n + rows - 1) / rows;
  if (q == nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        vq_any_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    if (int e = vq_common::sm_count(&sms)) return e;
    const int grid = (int)(tiles < sms ? tiles : sms);
    if (grid == 0) return 0;
    vq_any_kernel<false><<<grid, THREADS, smem, s>>>(x, cb, e2, idx, nullptr, nullptr, nullptr,
                                                     n, k_codes, d, rows, codes);
    return (int)cudaGetLastError();
  }
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_any_kernel<true>, smem, counts_i, k_codes, tiles,
                                   max_parts, s, &grid))
    return e;
  if (grid > 0)
    vq_any_kernel<true><<<grid, THREADS, smem, s>>>(x, cb, e2, idx, q, counts_i, sq_part, n,
                                                    k_codes, d, rows, codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

// Dynamic shared memory of a block of vq_any_fwd at width d, `rows` and
// `codes` (ops/nearest_codes.py search_smem_bytes restates it).
extern "C" int vq_any_smem_bytes(int d, int rows, int codes) {
  return (int)any_smem(d, rows, codes);
}
