// Flash attention's forward at any head width D from 1 to 256, on fp32 q, k,
// v (3xTF32 on mma.sync.m16n8k8) or bf16 ones (mma.sync.m16n8k16 bf16 ->
// fp32), with fp32 statistics and an fp32 output either way:
//   out = softmax(q . k^T * sm_scale + (1 - mask) * -1e9) . v
// over Sq query rows and Sk keys, each >= 1 and free of each other, and, when
// `lse` is not null (the wrapper's autograd forward), each query row's
// log-sum-exp less its sequence's shift, (m - shift) + log(l), (B, H, Sq).
//
// Replaces: msla_tpu/ops/flash_attn.py:51 _flash (JAX's TPU flash attention,
// jax.experimental.pallas.ops.tpu.flash_attention) at every head width but
// 64, which csrc/flash_attn.cu takes tuned. The JAX function takes any D; the
// Pallas kernel pads it to its lanes.
//
// Bound on an H100: 4 B H Sq Sk D FLOP (Q K^T and P V) against q, k, v read
// and out written once. TinyBERT-4L-312D's layer at Audio-BERT's batch-16
// fold (352 sequences x 12 heads x 512 x 26): 1.15e11 FLOP, 0.23 ms at the
// TF32 peak (three products 0.70 ms), against 0.90 GB, 0.27 ms at 3.35 TB/s:
// bound by bytes. Small D keeps attention below the card's ridge.
//
// Design: FA2 on mma.sync, the tiles and products of flash_tiles.cuh. A block
// of 4 warps takes 64 query rows of one (sequence, head), a warp 16; K and V
// come in tiles of BK keys (64, 32 for Dp > 128: the output accumulator, Dp
// / 2 fp32 a thread, takes the registers). D is padded to the mma's k step
// with zero columns in shared memory (8 in fp32, 16 in bf16): they add exact
// zeros to Q K^T, and V's padded columns are never stored. Shared memory:
// the Q tile and one K and one V tile of Dp + pad elements a row (133 KB at
// D = 256 in fp32). Loads are plain element loads and each tile waits on
// them: no overlap of loads and products.
// - Scores are s * sm_scale rounded, plus the mask's bias rounded (no FMA
//   contraction), as the plain version adds them, and -inf past Sk; sm_scale
//   is any value (1/sqrt(26) is no power of two, so it is not folded into Q).
//   A sequence whose keys are all padding has every score -1e9 (|s| < 32)
//   and gets the mean of v.
// - The online softmax keeps each row's running max m and sum l in
//   registers, the output rescaled by exp(m_old - m_new); p = 2^((s - m)
//   log2(e)) by ex2.approx. Row maxima and sums run in a fixed order (a
//   thread's values in order, then two __shfl_xor_sync steps), so run after
//   run gives the same bits.
// - bf16: each p is rounded to bf16 for P V (JAX's p.astype(v.dtype)) while
//   l takes it unrounded.
#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

template <typename T>
__host__ __device__ constexpr size_t fwd_smem(int dp, int bk) {
  return (size_t)(ROWS + 2 * bk) * ld_of<T>(dp) * sizeof(T) + sizeof(float) * bk;
}

template <typename T, int NO>
__global__ void __launch_bounds__(THREADS)
flash_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mask, const float* __restrict__ shift,
                 float* __restrict__ out, float* __restrict__ lse, int n_heads, int s_q,
                 int s_k, int d, float sm_scale) {
  constexpr int BK = Class<NO>::FWD, NT = BK / 8;
  const int dp = round_up(d, Op<T>::K), ld = ld_of<T>(dp), no = dp / 8;
  extern __shared__ float4 smem4[];
  Carve carve{reinterpret_cast<char*>(smem4)};
  T* qs = carve.take<T>((size_t)ROWS * ld);
  T* ks = carve.take<T>((size_t)BK * ld);
  T* vs = carve.take<T>((size_t)BK * ld);
  float* ms = carve.take<float>(BK);

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long stride = (long long)n_heads * d;
  const T* qh = q + (long long)b * s_q * stride + (long long)h * d;
  const T* kh = k + (long long)b * s_k * stride + (long long)h * d;
  const T* vh = v + (long long)b * s_k * stride + (long long)h * d;
  const float* mrow = mask ? mask + (long long)b * s_k : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  load_tile(qs, ld, qh, stride, q0, ROWS, s_q, d, dp);

  float o[NO][4], m[2], l[2];
  clear(o);
  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.f;

  for (int k0 = 0; k0 < s_k; k0 += BK) {
    __syncthreads();  // the previous tile's products are done with ks, vs, ms
    load_tile(ks, ld, kh, stride, k0, BK, s_k, d, dp);
    load_tile(vs, ld, vh, stride, k0, BK, s_k, d, dp);
    for (int i = threadIdx.x; mrow && i < BK; i += THREADS)
      ms[i] = k0 + i < s_k ? mrow[k0 + i] : 0.f;
    __syncthreads();

    float s[NT][4];
    scores(s, qs + 16 * warp * ld, ks, ld, dp, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const float bias = key_bias(mrow ? ms : nullptr, col, k0 + col < s_k);
        s[j][c] = scaled(s[j][c], sm_scale, bias);
        s[j][2 + c] = scaled(s[j][2 + c], sm_scale, bias);
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[0][2 * r], s[0][2 * r + 1]);
#pragma unroll
      for (int j = 1; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: key 0 of the first tile is in range
      const float alpha = ex2(__fmul_rn(m[r] - m_new, LOG2E));  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(__fmul_rn(s[j][2 * r + c] - m_new, LOG2E));
          s[j][2 * r + c] = p;
          sum += p;
        }
      m[r] = m_new;
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < NO; ++e) {
        o[e][2 * r] *= alpha;
        o[e][2 * r + 1] *= alpha;
      }
    }
    accumulate(o, s, vs, ld, no, lane);
  }

  const float c = shift ? shift[b] : 0.f;
  float* oh = out + (long long)b * s_q * stride + (long long)h * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= s_q) continue;
    if (lse && t == 0)
      lse[((long long)b * n_heads + h) * s_q + row] = __fadd_rn(m[r] - c, logf(sum));
#pragma unroll
    for (int e = 0; e < NO; ++e)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * e + 2 * t + cc;
        if (e < no && col < d) oh[(long long)row * stride + col] = o[e][2 * r + cc] * inv;
      }
  }
}

template <typename T, int NO>
int launch(const void* q, const void* k, const void* v, const float* mask, const float* shift,
           float* out, float* lse, int batch, int n_heads, int s_q, int s_k, int d,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(round_up(d, Op<T>::K), Class<NO>::FWD);
  if (int e = allow(flash_any_kernel<T, NO>, smem)) return e;
  if (batch == 0 || n_heads == 0) return 0;
  const dim3 grid((s_q + ROWS - 1) / ROWS, n_heads, batch);
  flash_any_kernel<T, NO><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, shift, out, lse, n_heads, s_q, s_k, d,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, const float* mask,
                 const float* shift, float* out, float* lse, int batch, int n_heads, int s_q,
                 int s_k, int d, float sm_scale, cudaStream_t stream) {
  switch (class_of(round_up(d, Op<T>::K))) {
    case 4:
      return launch<T, 4>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                          sm_scale, stream);
    case 8:
      return launch<T, 8>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                          sm_scale, stream);
    case 16:
      return launch<T, 16>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                           sm_scale, stream);
    default:
      return launch<T, 32>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                           sm_scale, stream);
  }
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); fp32, or bf16 with bf16_ops (out
// fp32 either way), contiguous; D from 1 to 256; mask: (B, Sk) fp32 or null;
// shift: (B,) fp32 or null (0); lse: (B, H, Sq) fp32 or null to skip it.
extern "C" int flash_any_fwd(int bf16_ops, const void* q, const void* k, const void* v,
                             const float* mask, const float* shift, float* out, float* lse,
                             int batch, int n_heads, int s_q, int s_k, int d, float sm_scale,
                             void* stream) {
  if (d < 1 || d > MAX_D || s_q < 1 || s_k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_ops)
    return launch_width<bf16>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                              sm_scale, s);
  return launch_width<float>(q, k, v, mask, shift, out, lse, batch, n_heads, s_q, s_k, d,
                             sm_scale, s);
}

// A forward block's dynamic shared memory at head width d (ops/flash_attn.py
// any_smem_bytes, part "fwd").
extern "C" int flash_any_smem_bytes(int bf16_ops, int d) {
  const int dp = round_up(d, bf16_ops ? 16 : 8), bk = fwd_step(class_of(dp));
  return (int)(bf16_ops ? fwd_smem<bf16>(dp, bk) : fwd_smem<float>(dp, bk));
}
