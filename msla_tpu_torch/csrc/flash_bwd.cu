// Flash attention's backward at any head width D from 1 to 256, on fp32 q, k,
// v (3xTF32 on mma.sync.m16n8k8) or bf16 ones (mma.sync.m16n8k16 bf16 ->
// fp32): from q, k, v, the forward's fp32 output O, the output's gradient dO
// and the forward's lse (each query row's log-sum-exp less its sequence's
// shift, csrc/flash_attn.cu and csrc/flash_any.cu), FA2's recompute:
//   s = q . k^T * sm_scale + (1 - mask) * -1e9,  P = exp((s - shift) - lse),
//   D_i = sum_d dO O,  dP = dO . V^T,  dS = P * (dP - D_i) * sm_scale,
//   dQ = dS . K,  dK = dS^T . Q,  dV = P^T . dO.
// Two kernels, as JAX has two:
// - flash_bwd_dq_kernel: a block owns 64 query rows and walks the key tiles.
//   Its prologue computes D_i for its rows (each a fixed-order sum over d)
//   and writes it to `delta`, (B, H, Sq), which the other kernel reads: the
//   wrapper launches this one first, on the same stream.
// - flash_bwd_dkv_kernel: a block owns 64 keys and walks the query tiles,
//   accumulating dV and dK: both in one launch, or at Dp > 128 two launches
//   of its own choosing, dV then dK, each pass holding one accumulator of
//   Dp / 2 fp32 a thread and recomputing P (and dP for dK). flash_bwd_dkv
//   reports how many it made, so the wrapper counts what was launched.
// No atomics: every sum runs in a fixed order within one block, so run after
// run gives the same bits.
//
// Replaces: JAX's TPU flash attention backward, which msla_tpu/ops/
// flash_attn.py:51 _flash reaches under jax.grad (its block sizes at :57-59):
// jax/experimental/pallas/ops/tpu/flash_attention.py:941
// _flash_attention_bwd_dkv (pl.pallas_call at :1121) and :1287
// _flash_attention_bwd_dq (:1456).
//
// Bound on an H100: five products, 2.5x the forward's FLOP (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K: 10 B H Sq Sk D), against q, k, v, O, dO and lse read
// and dq, dk, dv written once. The transformer's cross-attention at
// configs/model/transformer.yaml's widths (batch 64, 8 heads, 64 queries, a
// memory of 256 keys, D 64): 5.4e9 FLOP, 0.011 ms at the TF32 peak (three
// products 0.033 ms), against 64 MB, 0.019 ms at 3.35 TB/s: bound by bytes.
//
// Design: FA2's backward on mma.sync, the tiles and products of
// flash_tiles.cuh, D padded with zero columns in shared memory, plain element
// loads and no overlap of loads and products. The dQ kernel holds its Q and
// dO tiles and takes K and V in tiles of 64 keys (32 at Dp > 64, 16 at Dp >
// 128); the dK/dV kernel holds its K and V tiles and takes Q and dO in tiles
// of as many queries. Each warp owns 16 rows of its block (queries in dQ,
// keys in dK/dV); P and dS stay in registers (the C layout of one product is
// the A fragment of the next). The scores are the forward's, s * sm_scale
// rounded plus the bias rounded; keys past Sk carry -inf (P = 0), and query
// rows past Sq an lse of +inf (P = 0) and a D_i of 0, so they add nothing to
// dK and dV. A sequence whose keys are all padding has shift -1e9 and its
// lse keeps log Sk, so P is 1 / Sk there: a uniform softmax's gradient, as
// the plain chain's.
// - fp32: all five products in 3xTF32 (P and dS split in registers).
// - bf16 (JAX's TPU backward's rounding points): the wrapper passes dO in
//   bf16; P is rounded to bf16 before P^T dO and dS (sm_scale applied) before
//   dS K and dS^T Q, the sums are fp32, and dq, dk, dv are rounded to bf16
//   once at the end.
// Registers: the dK/dV kernel at Dp <= 128 holds both accumulators, 2 x Dp /
// 2 fp32 a thread (128 at Dp = 128); chip_smoke.py phase 33 prints ptxas's
// registers and spills of each instantiation.
#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

template <typename T>
__host__ __device__ constexpr size_t dq_smem(int dp, int bt) {
  return (size_t)(2 * ROWS + 2 * bt) * ld_of<T>(dp) * sizeof(T) +
         sizeof(float) * (bt + 2 * ROWS);
}

template <typename T>
__host__ __device__ constexpr size_t dkv_smem(int dp, int bt) {
  return (size_t)(2 * ROWS + 2 * bt) * ld_of<T>(dp) * sizeof(T) +
         sizeof(float) * (ROWS + 2 * bt);
}

// Rows [row0, row0 + n) of a (B, H, S) statistic into shared memory, `past`
// at rows >= s.
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src, int row0,
                                          int n, int s, float past) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = row0 + i < s ? src[row0 + i] : past;
}

template <typename T, int NO>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ mask, const float* __restrict__ shift,
                    const float* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int n_heads, int s_q, int s_k, int d, float sm_scale) {
  constexpr int BK = Class<NO>::BWD, NT = BK / 8;
  const int dp = round_up(d, Op<T>::K), ld = ld_of<T>(dp), no = dp / 8;
  extern __shared__ float4 smem4[];
  Carve carve{reinterpret_cast<char*>(smem4)};
  T* qs = carve.take<T>((size_t)ROWS * ld);
  T* dos = carve.take<T>((size_t)ROWS * ld);
  T* ks = carve.take<T>((size_t)BK * ld);
  T* vs = carve.take<T>((size_t)BK * ld);
  float* ms = carve.take<float>(BK);
  float* ls = carve.take<float>(ROWS);
  float* ds_ = carve.take<float>(ROWS);

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long stride = (long long)n_heads * d;
  const long long qbase = (long long)b * s_q * stride + (long long)h * d;
  const long long kbase = (long long)b * s_k * stride + (long long)h * d;
  const long long sbase = ((long long)b * n_heads + h) * s_q;  // lse, delta
  const float* mrow = mask ? mask + (long long)b * s_k : nullptr;
  const float c = shift ? shift[b] : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  load_tile(qs, ld, q + qbase, stride, q0, ROWS, s_q, d, dp);
  load_tile(dos, ld, dout + qbase, stride, q0, ROWS, s_q, d, dp);
  load_stat(ls, lse + sbase, q0, ROWS, s_q, CUDART_INF_F);
  __syncthreads();
  // D_i = sum_d dO O, one thread a row, d in order
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    float acc = 0.f;
    if (q0 + r < s_q) {
      const float* orow = out + qbase + (long long)(q0 + r) * stride;
      for (int e = 0; e < d; ++e) acc = fmaf(to_float(dos[r * ld + e]), orow[e], acc);
      delta[sbase + q0 + r] = acc;
    }
    ds_[r] = acc;
  }

  float acc[NO][4];
  clear(acc);
  for (int k0 = 0; k0 < s_k; k0 += BK) {
    __syncthreads();  // D_i is in shared memory; the previous tile is done with ks, vs, ms
    load_tile(ks, ld, k + kbase, stride, k0, BK, s_k, d, dp);
    load_tile(vs, ld, v + kbase, stride, k0, BK, s_k, d, dp);
    for (int i = threadIdx.x; mrow && i < BK; i += THREADS)
      ms[i] = k0 + i < s_k ? mrow[k0 + i] : 0.f;
    __syncthreads();

    float p[NT][4], dpv[NT][4];
    scores(p, qs + 16 * warp * ld, ks, ld, dp, lane);
    scores(dpv, dos + 16 * warp * ld, vs, ld, dp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      const float lr = ls[row], dr = ds_[row];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = 8 * j + 2 * t + cc;
          const float bias = key_bias(mrow ? ms : nullptr, col, k0 + col < s_k);
          const float pr = prob(scaled(p[j][2 * r + cc], sm_scale, bias), c, lr);
          p[j][2 * r + cc] = __fmul_rn(__fmul_rn(pr, __fsub_rn(dpv[j][2 * r + cc], dr)),
                                       sm_scale);  // dS
        }
    }
    accumulate(acc, p, ks, ld, no, lane);
  }

  T* dqh = dq + qbase;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= s_q) continue;
#pragma unroll
    for (int e = 0; e < NO; ++e)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * e + 2 * t + cc;
        if (e < no && col < d)
          dqh[(long long)row * stride + col] = from_float<T>(acc[e][2 * r + cc]);
      }
  }
}

// DV, DK: which of dV and dK this instantiation accumulates.
template <typename T, int NO, bool DV, bool DK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, const float* __restrict__ shift,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int n_heads, int s_q, int s_k, int d, float sm_scale) {
  constexpr int BQ = Class<NO>::BWD, NT = BQ / 8;
  const int dp = round_up(d, Op<T>::K), ld = ld_of<T>(dp), no = dp / 8;
  extern __shared__ float4 smem4[];
  Carve carve{reinterpret_cast<char*>(smem4)};
  T* ks = carve.take<T>((size_t)ROWS * ld);
  T* vs = carve.take<T>((size_t)ROWS * ld);
  T* qs = carve.take<T>((size_t)BQ * ld);
  T* dos = carve.take<T>((size_t)BQ * ld);
  float* ms = carve.take<float>(ROWS);
  float* ls = carve.take<float>(BQ);
  float* ds_ = carve.take<float>(BQ);

  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long stride = (long long)n_heads * d;
  const long long qbase = (long long)b * s_q * stride + (long long)h * d;
  const long long kbase = (long long)b * s_k * stride + (long long)h * d;
  const long long sbase = ((long long)b * n_heads + h) * s_q;
  const float c = shift ? shift[b] : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  load_tile(ks, ld, k + kbase, stride, k0, ROWS, s_k, d, dp);
  load_tile(vs, ld, v + kbase, stride, k0, ROWS, s_k, d, dp);
  for (int i = threadIdx.x; i < ROWS; i += THREADS)
    ms[i] = mask && k0 + i < s_k ? mask[(long long)b * s_k + k0 + i] : 0.f;
  __syncthreads();
  float bias[2];  // this thread's two keys' (rows g, g + 8 of its warp)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = 16 * warp + g + 8 * r;
    bias[r] = key_bias(mask ? ms : nullptr, key, k0 + key < s_k);
  }

  float acc_v[DV ? NO : 1][4], acc_k[DK ? NO : 1][4];
  clear(acc_v);
  clear(acc_k);
  for (int q0 = 0; q0 < s_q; q0 += BQ) {
    __syncthreads();  // the previous tile is done with qs, dos, ls, ds_
    load_tile(qs, ld, q + qbase, stride, q0, BQ, s_q, d, dp);
    load_tile(dos, ld, dout + qbase, stride, q0, BQ, s_q, d, dp);
    load_stat(ls, lse + sbase, q0, BQ, s_q, CUDART_INF_F);
    load_stat(ds_, delta + sbase, q0, BQ, s_q, 0.f);
    __syncthreads();

    // P^T (this warp's 16 keys x BQ queries) and, for dK, dP^T
    float p[NT][4];
    scores(p, ks + 16 * warp * ld, qs, ld, dp, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * j + 2 * t + cc;  // a query of the tile
#pragma unroll
        for (int r = 0; r < 2; ++r)
          p[j][2 * r + cc] = prob(scaled(p[j][2 * r + cc], sm_scale, bias[r]), c, ls[col]);
      }
    if constexpr (DV) accumulate(acc_v, p, dos, ld, no, lane);
    if constexpr (DK) {
      float dpt[NT][4];
      scores(dpt, vs + 16 * warp * ld, dos, ld, dp, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float dr = ds_[8 * j + 2 * t + cc];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            p[j][2 * r + cc] = __fmul_rn(
                __fmul_rn(p[j][2 * r + cc], __fsub_rn(dpt[j][2 * r + cc], dr)), sm_scale);
        }
      accumulate(acc_k, p, qs, ld, no, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + g + 8 * r;
    if (key >= s_k) continue;
    const long long at = kbase + (long long)key * stride;
#pragma unroll
    for (int e = 0; e < NO; ++e)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * e + 2 * t + cc;
        if (e >= no || col >= d) continue;
        if constexpr (DV) dv[at + col] = from_float<T>(acc_v[e][2 * r + cc]);
        if constexpr (DK) dk[at + col] = from_float<T>(acc_k[e][2 * r + cc]);
      }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *mask, *shift;
  int batch, n_heads, s_q, s_k, d;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int NO>
int launch_dq(const Args& a, const float* out, const void* dout, const float* lse,
              float* delta, void* dq) {
  const size_t smem = dq_smem<T>(round_up(a.d, Op<T>::K), Class<NO>::BWD);
  if (int e = allow(flash_bwd_dq_kernel<T, NO>, smem)) return e;
  if (a.batch == 0 || a.n_heads == 0) return 0;
  const dim3 grid((a.s_q + ROWS - 1) / ROWS, a.n_heads, a.batch);
  flash_bwd_dq_kernel<T, NO><<<grid, THREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.mask, a.shift, out, (const T*)dout, lse,
      delta, (T*)dq, a.n_heads, a.s_q, a.s_k, a.d, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int NO, bool DV, bool DK>
int launch_dkv(const Args& a, const void* dout, const float* lse, const float* delta, void* dk,
               void* dv) {
  const size_t smem = dkv_smem<T>(round_up(a.d, Op<T>::K), Class<NO>::BWD);
  if (int e = allow(flash_bwd_dkv_kernel<T, NO, DV, DK>, smem)) return e;
  if (a.batch == 0 || a.n_heads == 0) return 0;
  const dim3 grid((a.s_k + ROWS - 1) / ROWS, a.n_heads, a.batch);
  flash_bwd_dkv_kernel<T, NO, DV, DK><<<grid, THREADS, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.mask, a.shift, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, a.n_heads, a.s_q, a.s_k, a.d, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_width(const Args& a, const float* out, const void* dout, const float* lse, float* delta,
             void* dq) {
  switch (class_of(round_up(a.d, Op<T>::K))) {
    case 4:
      return launch_dq<T, 4>(a, out, dout, lse, delta, dq);
    case 8:
      return launch_dq<T, 8>(a, out, dout, lse, delta, dq);
    case 16:
      return launch_dq<T, 16>(a, out, dout, lse, delta, dq);
    default:
      return launch_dq<T, 32>(a, out, dout, lse, delta, dq);
  }
}

// Sets *launched to the launches made: 2 (dV, then dK, one accumulator a
// launch) in the widest class, else 1 (both).
template <typename T>
int dkv_width(const Args& a, const void* dout, const float* lse, const float* delta, void* dk,
              void* dv, int* launched) {
  const int no = class_of(round_up(a.d, Op<T>::K));
  *launched = 0;
  if (a.batch == 0 || a.n_heads == 0) return 0;
  if (no == 32) {
    if (int e = launch_dkv<T, 32, true, false>(a, dout, lse, delta, dk, dv)) return e;
    *launched = 1;
    if (int e = launch_dkv<T, 32, false, true>(a, dout, lse, delta, dk, dv)) return e;
    *launched = 2;
    return 0;
  }
  *launched = 1;
  switch (no) {
    case 4:
      return launch_dkv<T, 4, true, true>(a, dout, lse, delta, dk, dv);
    case 8:
      return launch_dkv<T, 8, true, true>(a, dout, lse, delta, dk, dv);
    default:
      return launch_dkv<T, 16, true, true>(a, dout, lse, delta, dk, dv);
  }
}

}  // namespace

// q, out, dout: (B, Sq, H, D); k, v: (B, Sk, H, D); q, k, v, dout fp32, or
// bf16 with bf16_ops; out fp32; all contiguous; D from 1 to 256; mask: (B,
// Sk) fp32 or null; shift: (B,) fp32 or null (0); lse, delta: (B, H, Sq) fp32
// (delta written here); dq in q's type. Launch before flash_bwd_dkv.
extern "C" int flash_bwd_dq(int bf16_ops, const void* q, const void* k, const void* v,
                            const float* mask, const float* shift, const float* out,
                            const void* dout, const float* lse, float* delta, void* dq,
                            int batch, int n_heads, int s_q, int s_k, int d, float sm_scale,
                            void* stream) {
  if (d < 1 || d > MAX_D || s_q < 1 || s_k < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, shift, batch, n_heads, s_q, s_k, d, sm_scale,
               (cudaStream_t)stream};
  return bf16_ops ? dq_width<bf16>(a, out, dout, lse, delta, dq)
                  : dq_width<float>(a, out, dout, lse, delta, dq);
}

// dk, dv: (B, Sk, H, D) in k's type; delta as flash_bwd_dq wrote it;
// *launched: the kernel launches made (1, or 2 at padded D > 128).
extern "C" int flash_bwd_dkv(int bf16_ops, const void* q, const void* k, const void* v,
                             const float* mask, const float* shift, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int batch, int n_heads, int s_q, int s_k, int d, float sm_scale,
                             void* stream, int* launched) {
  *launched = 0;
  if (d < 1 || d > MAX_D || s_q < 1 || s_k < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, shift, batch, n_heads, s_q, s_k, d, sm_scale,
               (cudaStream_t)stream};
  return bf16_ops ? dkv_width<bf16>(a, dout, lse, delta, dk, dv, launched)
                  : dkv_width<float>(a, dout, lse, delta, dk, dv, launched);
}

// A block's dynamic shared memory at head width d: the dQ kernel's (dkv 0)
// or the dK/dV kernel's (dkv 1) (ops/flash_attn.py any_smem_bytes).
extern "C" int flash_bwd_smem_bytes(int bf16_ops, int dkv, int d) {
  const int dp = round_up(d, bf16_ops ? 16 : 8), bt = bwd_step(class_of(dp));
  if (bf16_ops) return (int)(dkv ? dkv_smem<bf16>(dp, bt) : dq_smem<bf16>(dp, bt));
  return (int)(dkv ? dkv_smem<float>(dp, bt) : dq_smem<float>(dp, bt));
}
