// Flash attention with a key-padding mask, on fp32 q, k, v or, for the bf16
// compute_dtype, bf16 ones; fp32 statistics and an fp32 output either way:
//   out = softmax(q . k^T * sm_scale + (1 - mask) * -1e9) . v
// per (sequence, head), without the (S, S) scores ever reaching device memory.
//
// Replaces: msla_tpu/ops/flash_attn.py:51 _flash (JAX's bundled TPU flash
// attention, jax.experimental.pallas.ops.tpu.flash_attention).
//
// Bound on an H100: one BERT layer of the batch-16 Audio-BERT call has 352
// sequences x 12 heads x 512 tokens x 64 dims. QK^T and PV are 4*B*H*S*S*D =
// 2.83e11 fp32 FLOP against q, k, v and out of 554 MB each (2.2 GB), so it is
// bound by the fp32 FMA rate (67 TFLOP/s outside the tensor cores): >= 4.2 ms.
// In bf16 the inputs are 277 MB and the output 554 MB (831 MB, 0.25 ms at
// 3.35 TB/s), and the FLOP held to the bf16 tensor-core peak (989 TFLOP/s)
// take 0.29 ms: bound by operations. This kernel does not reach for that
// bound: it runs the bf16 function on the fp32 FMA units (R3, ROADMAP.md).
//
// Design: one block per (query tile of 64 rows, head, sequence), 256 threads.
// The Q tile stays in shared memory; the 512 keys are walked in tiles of 64
// (a whole (512, 64) K plus V is 256 KB, more than a block's 227 KB), with an
// online softmax in fp32: running row max m, running row sum l, and the
// output accumulator rescaled by exp(m_old - m_new). Thread (ty, tx) owns
// query rows ty + 16i and, in QK^T, keys tx + 16j (i, j < 4): a row's 16
// threads are one half-warp, so row maxima and sums are butterfly shuffles
// in a fixed order (deterministic). In PV it owns output columns 4tx..4tx+3,
// read as float4 from V. Shared rows are padded to 68 floats so the float4
// reads of 16 threads hit distinct banks.
//
// The mask is added as the plain version adds it: s * sm_scale, rounded, plus
// (1 - mask) * -1e9, rounded (no FMA contraction). A sequence whose keys are
// all padding then has every score equal to -1e9 in fp32 (for |s| < 32) and
// its softmax is uniform: its output is the mean of v, as in the plain
// version, not 0/0. Keys past the sequence end (S not a multiple of 64) are
// dropped entirely. q, k, v and out are read and written in the projections'
// (B, S, H, D) layout, so no transpose is needed on either side.
//
// bf16 (JAX's TPU kernel on bf16 q, k, v): the tiles are widened to fp32 as
// they enter shared memory, so the scores are fp32 sums of exact products and
// the statistics fp32, as before; each p = exp(s - m) is rounded to bf16 for
// P . V (the kernel's p.astype(v.dtype)) while the row sum l takes it unrounded,
// and the output stays fp32. The plain version rounds the normalised
// probabilities instead, so the two part by up to 2^-8 of sum_k p_k |v_k|.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "operand_type.cuh"

namespace {

using operand_type::round_to;

constexpr int D = 64;        // head dim the kernel is compiled for
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;
constexpr int LD = D + 4;    // padded shared row (floats): float4-aligned, conflict-free
constexpr int SMEM_FLOATS = BQ * LD + 2 * BK * LD + BQ * (BK + 4) + BK;

// Copy rows [row0, row0 + 64) of one head from a (B, S, H, D) tensor into a
// padded (64, LD) fp32 shared tile; rows at or past S are zero.
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src, int row0,
                                          int seq_len, long long row_stride) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += THREADS) {
    const int r = idx >> 4, c4 = idx & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq_len)
      v = reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride)[c4];
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c4) = v;
  }
}

// The same from bf16: 16 bytes (8 values) a load, widened to fp32 (exact).
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src, int row0,
                                          int seq_len, long long row_stride) {
  for (int idx = threadIdx.x; idx < 64 * (D / 8); idx += THREADS) {
    const int r = idx >> 3, c8 = idx & 7;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq_len)
      u = reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride)[c8];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
    *reinterpret_cast<float4*>(dst + r * LD + 8 * c8) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(dst + r * LD + 8 * c8 + 4) = make_float4(c.x, c.y, d.x, d.y);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mask,
                  float* __restrict__ out, int n_heads, int seq_len, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                 // [BQ][LD]
  float* ks = qs + BQ * LD;         // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* ps = vs + BK * LD;         // [BQ][BK + 4]
  float* bias = ps + BQ * (BK + 4);  // [BK]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)n_heads * D;
  const long long base = (long long)b * seq_len * row_stride + (long long)h * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile(qs, q + base, q0, seq_len, row_stride);

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq_len; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    load_tile(ks, k + base, k0, seq_len, row_stride);
    load_tile(vs, v + base, k0, seq_len, row_stride);
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      float bv = -CUDART_INF_F;  // past the end: no weight at all
      if (key < seq_len)
        bv = mask ? __fmul_rn(1.f - mask[(long long)b * seq_len + key], -1e9f) : 0.f;
      bias[threadIdx.x] = bv;
    }
    __syncthreads();

    // s = Q K^T for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bj = bias[tx + 16 * j];
        s[i][j] = (bj == -CUDART_INF_F) ? -CUDART_INF_F
                                        : __fadd_rn(__fmul_rn(s[i][j], sm_scale), bj);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // key 0 of the first tile is always in range, so m_new is finite
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        part += p;
        ps[(ty + 16 * i) * (BK + 4) + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + part;  // this thread's keys only; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16i, columns 4tx..4tx+3
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pf[4], vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * (BK + 4) + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vf[e] = *reinterpret_cast<const float4*>(vs + (kk + e) * LD + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk[4] = {pf[i].x, pf[i].y, pf[i].z, pf[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][0] = fmaf(pk[e], vf[e].x, acc[i][0]);
          acc[i][1] = fmaf(pk[e], vf[e].y, acc[i][1]);
          acc[i][2] = fmaf(pk[e], vf[e].z, acc[i][2]);
          acc[i][3] = fmaf(pk[e], vf[e].w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / half_warp_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row < seq_len) {
      float4 o = make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                             acc[i][3] * inv);
      reinterpret_cast<float4*>(out + base + (long long)row * row_stride)[tx] = o;
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* mask, float* out, int batch,
           int n_heads, int seq_len, float sm_scale, void* stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || seq_len == 0 || n_heads == 0) return 0;
  const dim3 grid((seq_len + BQ - 1) / BQ, n_heads, batch);
  flash_attn_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, mask, out, n_heads, seq_len, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, S, H, 64) fp32, contiguous, 16-byte aligned; mask: (B, S)
// fp32 (1 attend, 0 pad) or null for no mask.
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              const float* mask, float* out, int batch, int n_heads,
                              int seq_len, float sm_scale, void* stream) {
  return launch<float>(q, k, v, mask, out, batch, n_heads, seq_len, sm_scale, stream);
}

// The same with bf16 q, k, v; out stays fp32.
extern "C" int flash_attn_bf16_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const float* mask, float* out,
                                   int batch, int n_heads, int seq_len, float sm_scale,
                                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, batch, n_heads, seq_len, sm_scale, stream);
}
