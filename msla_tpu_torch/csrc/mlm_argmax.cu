// Fused tied-decoder argmax of a masked LM:
//   ids[m]  = argmax_v (h[m] . E[v] + b[v])           (first maximum wins)
//   conf[m] = exp(max_v logit - logsumexp_v logit)     (conf variant)
// without the (M, V) logits ever reaching device memory.
//
// Replaces: msla_tpu/ops/mlm_argmax.py:47 _argmax_kernel and :67
// _argmax_conf_kernel (mlm_argmax_pallas).
//
// Bound on an H100: the batch-16 Audio-BERT call has M = 352 x 512 = 180,224
// rows of width 768 against V = 30,522 vocab rows: 2*M*V*768 = 8.45e12 fp32
// FLOP, while the inputs are 554 MB + 94 MB and the outputs 0.7 MB (1.4 MB
// with conf). It is bound by the fp32 FMA rate (67 TFLOP/s outside the tensor
// cores): >= 126 ms. The logits it never writes would be 22 GB.
//
// Design: a tiled SGEMM whose epilogue is a reduction. Each block owns 128
// rows and walks the whole vocab in tiles of 128 itself: on the card nothing
// carries between blocks as the TPU grid's scratch does. The 768-deep
// reduction is streamed through shared memory in chunks of 8 (h and E
// transposed, k-major, double-buffered: the next chunk is fetched into
// registers while the current one is multiplied). Thread (ty, tx) of 16 x 16
// keeps an 8 x 8 register tile of logits: rows 4ty..4ty+3 and 64+4ty..,
// columns 4tx..4tx+3 and 64+4tx.. of the tile (float4 reads of shared
// memory, conflict-free). After each vocab tile it folds its 8 columns into a
// running (max, argmax) per row, in ascending column order with a strict >,
// and in the conf variant into an online sum of exp(logit - max); that state
// lives in shared memory (24 KB), so the main loop keeps its registers for
// the tile and does not spill. Columns past V are skipped (the TPU kernel
// gives them bias -1e30). At the end the 16
// threads of a row (one half-warp) combine their partials by butterfly
// shuffles: greater value, or equal value and lower index, which gives the
// first maximum whatever the order; the sums in a fixed order, so the
// confidences are the same run after run. fp32 FMA throughout, no tensor
// cores: TF32 would flip argmaxes on near-ties.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 768;     // hidden width the kernel is compiled for
constexpr int BM = 128;    // rows per block
constexpr int BN = 128;    // vocab rows per tile
constexpr int BKC = 8;     // reduction chunk
constexpr int THREADS = 256;
constexpr int K_STEPS = K / BKC;
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

template <bool WITH_CONF>
__global__ void __launch_bounds__(THREADS, 2)
mlm_argmax_kernel(const float* __restrict__ h, const float* __restrict__ emb,
                  const float* __restrict__ bias, int* __restrict__ ids,
                  float* __restrict__ conf, long long m_rows, int vocab) {
  __shared__ __align__(16) float as[2][BKC][BM];
  __shared__ __align__(16) float bs[2][BKC][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  // the global chunk this thread fetches: row tid / 2, columns 4 (tid & 1) + 0..3
  const int ld_row = tid >> 1, ld_col = (tid & 1) * 4;
  const bool a_in = m0 + ld_row < m_rows;
  const float* a_src = h + (m0 + ld_row) * K + ld_col;

  // each thread's running state for its 8 rows, in shared memory: it is
  // touched once per vocab tile, and in registers it would crowd the tile
  __shared__ float st_m[8][THREADS], st_s[8][THREADS];
  __shared__ int st_idx[8][THREADS];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st_m[i][tid] = -CUDART_INF_F;
    st_s[i][tid] = 0.f;
    st_idx[i][tid] = NO_INDEX;
  }

  const int n_tiles = (vocab + BN - 1) / BN;
  const long long steps = (long long)n_tiles * K_STEPS;

  auto fetch = [&](long long step, float4& a, float4& b) {
    const int n0 = (int)(step / K_STEPS) * BN;
    const int k0 = (int)(step % K_STEPS) * BKC;
    a = a_in ? *reinterpret_cast<const float4*>(a_src + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
    b = n0 + ld_row < vocab
            ? *reinterpret_cast<const float4*>(emb + (long long)(n0 + ld_row) * K + ld_col + k0)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stash = [&](int buf, const float4& a, const float4& b) {
    as[buf][ld_col + 0][ld_row] = a.x; as[buf][ld_col + 1][ld_row] = a.y;
    as[buf][ld_col + 2][ld_row] = a.z; as[buf][ld_col + 3][ld_row] = a.w;
    bs[buf][ld_col + 0][ld_row] = b.x; bs[buf][ld_col + 1][ld_row] = b.y;
    bs[buf][ld_col + 2][ld_row] = b.z; bs[buf][ld_col + 3][ld_row] = b.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 a_next, b_next;
  fetch(0, a_next, b_next);
  stash(0, a_next, b_next);
  __syncthreads();

  int buf = 0;
  for (long long step = 0; step < steps; ++step) {
    const bool more = step + 1 < steps;
    if (more) fetch(step + 1, a_next, b_next);

#pragma unroll
    for (int kk = 0; kk < BKC; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (more) stash(buf ^ 1, a_next, b_next);
    __syncthreads();
    buf ^= 1;

    if ((step + 1) % K_STEPS == 0) {  // a vocab tile is complete: fold it in
      const int n0 = (int)(step / K_STEPS) * BN;
      int cols[8];
      float bj[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // ascending columns
        cols[j] = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        bj[j] = cols[j] < vocab ? bias[cols[j]] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float m = st_m[i][tid], sum = st_s[i][tid];
        int idx = st_idx[i][tid];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cols[j] >= vocab) continue;
          const float logit = acc[i][j] + bj[j];
          if (logit > m) {
            if (WITH_CONF) sum = sum * expf(m - logit) + 1.f;
            m = logit;
            idx = cols[j];
          } else if (WITH_CONF) {
            sum += expf(logit - m);
          }
        }
        st_m[i][tid] = m;
        st_s[i][tid] = sum;
        st_idx[i][tid] = idx;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }

  // the 16 threads of a row are the 16 lanes of a half-warp: butterfly
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Best best = {st_m[i][tid], st_s[i][tid], st_idx[i][tid]};
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      Best other;
      other.m = __shfl_xor_sync(0xffffffffu, best.m, o);
      other.s = __shfl_xor_sync(0xffffffffu, best.s, o);
      other.idx = __shfl_xor_sync(0xffffffffu, best.idx, o);
      combine(best, other, WITH_CONF);
    }
    const long long row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (tx == 0 && row < m_rows) {
      ids[row] = best.idx;
      if (WITH_CONF) {
        const float lse = logf(best.s) + best.m;
        conf[row] = expf(best.m - lse);
      }
    }
  }
}

template <bool WITH_CONF>
int launch(const float* h, const float* emb, const float* bias, int* ids, float* conf,
           long long m_rows, int vocab, void* stream) {
  if (m_rows == 0) return 0;
  const long long blocks = (m_rows + BM - 1) / BM;
  mlm_argmax_kernel<WITH_CONF><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      h, emb, bias, ids, conf, m_rows, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

// h: (M, 768), emb: (V, 768), bias: (V,) fp32 contiguous; ids: (M,) int32.
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
