// The VQ-VAE stems at any width: the encoder stem, conv k4 s2 p1 (4 -> C1) +
// ReLU then conv k4 s2 p1 (C1 -> C2) + ReLU, and the decoder stem, convT k4
// s2 p1 (C -> C1) + ReLU then convT k4 s2 p1 (C1 -> 4), each in one pass over
// device memory, on fp32 operands (3xTF32 on mma.sync.m16n8k8) or bf16 ones
// (mma.sync.m16n8k16 bf16 -> fp32, the biases fp32), with the widths as
// arguments: conv_stem_any_kernel and deconv_stem_any_kernel.
//
// Replaces, at the widths conv_stem.cu and deconv_stem.cu are not compiled
// for: msla_tpu/ops/conv_stem.py:48 _stem_kernel (K1; with a non-null
// `hidden` K1b, the pallas_call at conv_stem.py:132) and
// msla_tpu/ops/deconv_stem.py:35 _deconv_kernel (K2; K2b at
// deconv_stem.py:132). The JAX VQ-VAE builds its stems at c1 = num_hidden / 2
// for any num_hidden (msla_tpu/nn/encoder.py:33-38, decoder.py:41-48); the
// tuned kernels take the widths of configs/hparams_search/optuna.yaml only.
//
// The arithmetic, cast points and layouts are conv_stem.cu's and
// deconv_stem.cu's (their notes): the same packed operands (conv1's window
// of 4 samples x 4 channels a row, conv2's W2' over [hO[i]; hE[i]; hO[i+1];
// hE[i+1]]; the decoder's W1' over [q[r-1]; q[r]] and W2' over [h[2l];
// h[2l-1]; h[2l+1]; h[2l+2]]), the same fp32 split (tf32_split.cuh), h rounded
// to bf16 before the second layer in bf16. What differs is the shape of the
// work:
// - Widths are run-time values, padded to the mma's granule: the depth of a
//   product to its k step (8 in fp32, 16 in bf16: C1 of conv2, C and C1 of
//   the decoder's layers), conv2's output channels to 16 (the m16 tile). A
//   padded lane adds exact zeros: its weights and bias read as 0 (the loads
//   test the true widths), so a padded channel of h is relu(0) = 0 and a
//   padded column multiplies a zero weight; padded outputs are never stored.
//   No tensor is padded in device memory, and the outputs and hiddens have
//   the true widths.
// - Weights are read from their torch layouts in device memory (L2 holds
//   them: 2 MB at num_hidden 512) as each fragment is loaded, not packed into
//   shared memory once a block: the wide stems' W2' (C2 x 4 C1, 2 MB) or W1'
//   (2 C1 x 2 C) outgrow a block. Shared memory holds the tile's inputs and
//   h only, which sets the tile (plan_stem in ops/conv_stem.py and
//   ops/deconv_stem.py picks it; stem_any_smem_bytes reports it).
// - Encoder: a block takes one tile of TILE output positions and one group
//   of at most 64 output channels, recomputing conv1 for its tile (all C1
//   channels: 8 / 64 of conv2's products at most); conv2 is one chain over
//   the depth, a warp a tile of 16 channels x 32 positions. Group 0 writes
//   h1 (K1b).
// - Decoder: a block takes one tile of TILE positions of q; layer 1 is one
//   chain over W1''s depth in order (q[r-1]'s channels, then q[r]'s), a warp
//   a tile of 16 rows x 32 columns; layer 2's depth (4 C1) is cut into 8
//   contiguous runs, one a warp, whose partial sums are added in warp order
//   through shared memory, then b2: 8 partial sums (deconv_stem.py
//   second_layer_chains).
// - bf16: each k16 step's products go into a zeroed accumulator and are
//   added to the fp32 sum in fp32 (round to nearest), since the tensor
//   cores' accumulator truncates. With partial sums of 8 steps, as
//   conv_stem.cu's bf16 kernel runs them, the decoder at num_hidden 512
//   (a 1,024-deep first layer) left 1.24e-4 of its bf16 outputs more than 2
//   ulps from the plain version's (h rounded apart; an H100, chip_smoke.py
//   phase 32), past check_bf16's 1e-4.
// Blocks are not persistent and loads are plain (no overlap of loads and
// products): these are the simple kernels that are right at every width;
// chip_smoke.py phase 32 times them beside the plain versions and cuDNN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int THREADS = 256;            // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int C0 = 4;                   // the encoder's input channels
constexpr int C_OUT = 4;                // the decoder's output channels
constexpr int MAX_GROUP = 64;           // output channels an encoder block takes

// The depth of one mma step in each operand type, and the elements a
// shared-memory row is padded by (fragment loads on 32 banks).
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int K = 8, PAD = 4;
};
template <>
struct Op<bf16> {
  static constexpr int K = 16, PAD = 8;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// Two bf16 values as one mma operand register, `lo` at the lower half.
__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a . b over one m16n8k16 tile, bf16 inputs: the tile's products from
// a zeroed accumulator, then added to c in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float p[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e];
}

// An fp32 A fragment split once for the n tiles it meets.
struct SplitA {
  uint32_t h[4], l[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__float_as_uint(a[e]), h[e], l[e]);
  }
};

// c += A . B in 3xTF32, B's fragment (b0, b1) split here.
__device__ __forceinline__ void mma_split(float (&c)[4], const SplitA& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(__float_as_uint(b0), bh0, bl0);
  split(__float_as_uint(b1), bh1, bl1);
  mma_3xtf32(c, a.h, a.l, bh0, bh1, bl0, bl1);
}

// A B fragment from a shared-memory row of B's column (k contiguous): fp32
// (b0, b1) = (row[t], row[t + 4]); bf16 b0 = row[2t, 2t + 1], b1 = row[2t +
// 8, 2t + 9].
__device__ __forceinline__ void b_frag(const float* row, int t, float& b0, float& b1) {
  b0 = row[t];
  b1 = row[t + 4];
}
__device__ __forceinline__ void b_frag(const bf16* row, int t, uint32_t& b0, uint32_t& b1) {
  b0 = *reinterpret_cast<const uint32_t*>(row + 2 * t);
  b1 = *reinterpret_cast<const uint32_t*>(row + 2 * t + 8);
}

// One k step's A rows (the fragment's rows g and g + 8), read from a weight
// in device memory: column cc + e of a row is base[e * stride], and 0 where
// the row is padding (!ok) or the column is (cc + e >= limit).
template <typename T>
struct ARows {
  const T* base[2];
  bool ok[2];
  int stride, cc, limit;
  __device__ __forceinline__ T at(int r, int e) const {
    return ok[r] && cc + e < limit ? base[r][(size_t)e * stride] : from_float<T>(0.f);
  }
};

// acc[j] += A . B over one k step for the n8 tiles j < nj: A from `a`, B's
// column n of tile j the shared-memory row brow + (8 j + n) ldb (k
// contiguous). fp32 in 3xTF32 (k8), bf16 exact (k16).
template <int NJ>
__device__ __forceinline__ void mma_step(float (&acc)[NJ][4], const ARows<float>& a,
                                         const float* brow, int ldb, int nj, int t) {
  const float v[4] = {a.at(0, t), a.at(1, t), a.at(0, t + 4), a.at(1, t + 4)};
  const SplitA sa(v);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < nj) {
      float b0, b1;
      b_frag(brow + 8 * j * ldb, t, b0, b1);
      mma_split(acc[j], sa, b0, b1);
    }
}
template <int NJ>
__device__ __forceinline__ void mma_step(float (&acc)[NJ][4], const ARows<bf16>& a,
                                         const bf16* brow, int ldb, int nj, int t) {
  const uint32_t v[4] = {pair(a.at(0, 2 * t), a.at(0, 2 * t + 1)),
                         pair(a.at(1, 2 * t), a.at(1, 2 * t + 1)),
                         pair(a.at(0, 2 * t + 8), a.at(0, 2 * t + 9)),
                         pair(a.at(1, 2 * t + 8), a.at(1, 2 * t + 9))};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < nj) {
      uint32_t b0, b1;
      b_frag(brow + 8 * j * ldb, t, b0, b1);
      mma_bf16(acc[j], v, b0, b1);
    }
}

// ---- the encoder stem ---------------------------------------------------------

// Shared memory of an encoder block at a padded C1 and a tile: the x window
// [C0][4 TILE + 16], then hE and hO, [TILE + 2][C1P + PAD] each.
template <typename T>
__host__ __device__ constexpr size_t conv_smem(int c1p, int tile) {
  return align16((size_t)C0 * (4 * tile + 16) * sizeof(T)) +
         2 * align16((size_t)(tile + 2) * (c1p + Op<T>::PAD) * sizeof(T));
}

// Block (tile, group): blockIdx.x = tile_index * groups + group; w1t (16,
// C1) is [c0*4 + tap][c1], w2t (4 C1, C2) is [c1*4 + tap][c2], as
// ops/conv_stem.py packs them for every fp32 kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_stem_any_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                     const float* __restrict__ b1, const T* __restrict__ w2t,
                     const float* __restrict__ b2, T* __restrict__ out, T* __restrict__ hidden,
                     int t_len, int c1, int c2, int tile) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KS = Op<T>::K;
  const int c1p = round_up(c1, KS), c2p = round_up(c2, 16);
  const int groups = (c2p + MAX_GROUP - 1) / MAX_GROUP;
  const int xw = 4 * tile + 16, krows = 2 * tile + 2, h_ld = c1p + Op<T>::PAD;
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  T* hse = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) +
                                align16((size_t)C0 * xw * sizeof(T)));
  T* hso = reinterpret_cast<T*>(reinterpret_cast<char*>(hse) +
                                align16((size_t)(tile + 2) * h_ld * sizeof(T)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w1_len = t_len / 2, w2_len = t_len / 4;
  const int tiles_per_row = (w2_len + tile - 1) / tile;
  const int group = blockIdx.x % groups;
  const long long tix = blockIdx.x / groups;
  const int b = (int)(tix / tiles_per_row), q0 = (int)(tix % tiles_per_row) * tile;
  const int n_valid = min(tile, w2_len - q0);
  const int cg0 = MAX_GROUP * group, cgn = min(MAX_GROUP, c2p - cg0);

  // xs[c0][u] = x[b][c0][4 q0 - 8 + u], zero outside [0, T)
  const T* xb = x + (size_t)b * C0 * t_len;
  for (int i = tid; i < C0 * xw; i += THREADS) {
    const int c = i / xw, s = 4 * q0 - 8 + i % xw;
    xs[i] = (s >= 0 && s < t_len) ? xb[(size_t)c * t_len + s] : from_float<T>(0.f);
  }
  __syncthreads();

  // conv1: item (mt, ni) is rows 16 mt .. of the tile's h1 rows k (h1[2 q0 -
  // 1 + k]) x channels 8 ni ..; row k's A row is x[c0][4 q0 - 3 + 2k + tap]
  // at u = 5 + 2k + tap (rows past krows repeat the last and are not stored)
  {
    const int mt1 = (krows + 15) / 16, nt1 = c1p / 8;
    for (int item = warp; item < mt1 * nt1; item += WARPS) {
      const int mt = item / nt1, ch = 8 * (item % nt1) + g;  // B's column: channel ch
      const int ka = 16 * mt + g, kb = ka + 8;
      const int ua = 5 + 2 * min(ka, krows - 1), ub = 5 + 2 * min(kb, krows - 1);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      // W1[ch][col] = w1t[col][ch], col = c0*4 + tap; zero on a padded channel
      auto w1 = [&](int col) { return ch < c1 ? w1t[col * c1 + ch] : from_float<T>(0.f); };
      if constexpr (F32) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // k8 step s: c0 = 2s (columns t), 2s + 1 (t + 4)
          const float a[4] = {xs[2 * s * xw + ua + t], xs[2 * s * xw + ub + t],
                              xs[(2 * s + 1) * xw + ua + t], xs[(2 * s + 1) * xw + ub + t]};
          mma_split(c, SplitA(a), w1(8 * s + t), w1(8 * s + t + 4));
        }
      } else {  // one k16 step: A[k][2t, 2t + 1] = x[t / 2][.. 2 (t % 2) ..]
        const int o = 2 * (t & 1), c0a = t >> 1, c0b = c0a + 2;
        const uint32_t a[4] = {pair(xs[c0a * xw + ua + o], xs[c0a * xw + ua + o + 1]),
                               pair(xs[c0a * xw + ub + o], xs[c0a * xw + ub + o + 1]),
                               pair(xs[c0b * xw + ua + o], xs[c0b * xw + ua + o + 1]),
                               pair(xs[c0b * xw + ub + o], xs[c0b * xw + ub + o + 1])};
        mma_bf16(c, a, pair(w1(2 * t), w1(2 * t + 1)), pair(w1(2 * t + 8), w1(2 * t + 9)));
      }
      // rows ka and kb have g's parity: both go to hO (even k) or hE (odd k)
      T* hs = (g & 1) ? hse : hso;
      const int c0 = 8 * (item % nt1) + 2 * t;
      const float bias0 = c0 < c1 ? b1[c0] : 0.f, bias1 = c0 + 1 < c1 ? b1[c0 + 1] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = r ? kb : ka, j = 2 * q0 - 1 + k;
        if (k < krows) {
          const bool inside = j >= 0 && j < w1_len;
          hs[(k >> 1) * h_ld + c0] = from_float<T>(inside ? fmaxf(c[2 * r] + bias0, 0.f) : 0.f);
          hs[(k >> 1) * h_ld + c0 + 1] =
              from_float<T>(inside ? fmaxf(c[2 * r + 1] + bias1, 0.f) : 0.f);
        }
      }
    }
  }
  __syncthreads();

  // K1b, group 0: h1[2 (q0 + i)] = hE[i], h1[2 (q0 + i) + 1] = hO[i + 1]
  if (hidden != nullptr && group == 0) {
    for (int e = tid; e < c1 * tile; e += THREADS) {
      const int c = e / tile, i = e % tile;
      if (i < n_valid) {
        T* dst = hidden + ((size_t)b * c1 + c) * w1_len + 2 * (q0 + i);
        dst[0] = hse[i * h_ld + c];
        dst[1] = hso[(i + 1) * h_ld + c];
      }
    }
    // where T/2 is odd, the row's last tile also writes h1[T/2 - 1] = hE[n_valid]
    if (w1_len % 2 == 1 && q0 + tile >= w2_len)
      for (int c = tid; c < c1; c += THREADS)
        hidden[((size_t)b * c1 + c) * w1_len + w1_len - 1] = hse[n_valid * h_ld + c];
  }

  // conv2: item (mt, nq) is the group's channels 16 mt .. x positions 32 nq
  // ..; depth k = tap * C1P + c1 over tap 0 hO[i], 1 hE[i], 2 hO[i + 1], 3
  // hE[i + 1], a k step within one tap; W2'[c2][k] = w2t[(c1*4 + tap) C2 +
  // c2], zero where padded
  for (int item = warp; item < (cgn / 16) * (tile / 32); item += WARPS) {
    const int mt = item % (cgn / 16), nq = item / (cgn / 16);
    const int ca = cg0 + 16 * mt + g, cb = ca + 8;  // A's rows: output channels
    float acc[4][4] = {};
    for (int tap = 0; tap < 4; ++tap) {
      const T* hs = ((tap & 1) ? hse : hso) + (32 * nq + g + (tap >> 1)) * h_ld;
      for (int cc = 0; cc < c1p; cc += KS) {
        const size_t col = (size_t)(cc * 4 + tap) * c2;
        const ARows<T> a{{w2t + col + ca, w2t + col + cb}, {ca < c2, cb < c2}, 4 * c2, cc, c1};
        mma_step(acc, a, hs + cc, h_ld, 4, t);
      }
    }
    // + b2, ReLU, to out[b][c2][q0 + i]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c2i = r ? cb : ca, i = 32 * nq + 8 * j + 2 * t;
        if (c2i >= c2) continue;
        T* dst = out + ((size_t)b * c2 + c2i) * w2_len + q0 + i;
        const float bias = b2[c2i];
        if (i < n_valid) dst[0] = from_float<T>(fmaxf(acc[j][2 * r] + bias, 0.f));
        if (i + 1 < n_valid) dst[1] = from_float<T>(fmaxf(acc[j][2 * r + 1] + bias, 0.f));
      }
  }
}

// ---- the decoder stem -----------------------------------------------------------

// The tap of w2 that row set s (0: h[2l], 1: h[2l-1], 2: h[2l+1], 3: h[2l+2])
// multiplies into out[4l + j], or -1 (ops/deconv_stem.py _W2_TAPS).
__constant__ int W2_TAPS[4][4] = {{1, 2, 3, -1}, {3, -1, -1, -1}, {-1, 0, 1, 2}, {-1, -1, -1, 0}};

// Shared memory of a decoder block at padded C and C1 and a tile: q's tile
// position-major [TILE + 9][CP + PAD] (or, over it once layer 1 is done, the
// 8 warps' partial sums of layer 2 [8][16][TILE] fp32), then hE and hO,
// [TILE + 8][C1P + PAD] each.
template <typename T>
__host__ __device__ constexpr size_t deconv_smem(int cp, int c1p, int tile) {
  const size_t qs = (size_t)(tile + 9) * (cp + Op<T>::PAD) * sizeof(T);
  const size_t ps = (size_t)WARPS * 16 * tile * sizeof(float);
  return align16(qs > ps ? qs : ps) +
         2 * align16((size_t)(tile + 8) * (c1p + Op<T>::PAD) * sizeof(T));
}

// Block = one tile of TILE positions l of q (out's 4l .. 4l + 3); w1 (C, C1,
// 4) and w2 (C1, 4, 4) in torch's ConvTranspose1d layout.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
deconv_stem_any_kernel(const T* __restrict__ q, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, T* __restrict__ out, T* __restrict__ hidden,
                       int w_len, int c, int c1, int tile) {
  constexpr int KS = Op<T>::K;
  const int cp = round_up(c, KS), c1p = round_up(c1, KS);
  const int q_ld = cp + Op<T>::PAD, h_ld = c1p + Op<T>::PAD, q_rows = tile + 9;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  float* ps = reinterpret_cast<float*>(smem4);  // over qs, after layer 1
  const size_t qs_bytes = (size_t)q_rows * q_ld * sizeof(T);
  const size_t ps_bytes = (size_t)WARPS * 16 * tile * sizeof(float);
  T* hse = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) +
                                align16(qs_bytes > ps_bytes ? qs_bytes : ps_bytes));
  T* hso = reinterpret_cast<T*>(reinterpret_cast<char*>(hse) +
                                align16((size_t)(tile + 8) * h_ld * sizeof(T)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_per_row = (w_len + tile - 1) / tile;
  const int b = blockIdx.x / tiles_per_row, l0 = (blockIdx.x % tiles_per_row) * tile;
  const int n_valid = min(tile, w_len - l0);

  // qs[j][ci] = q[b][ci][l0 - 1 + j], zero outside [0, W) and past C
  const T* qb = q + (size_t)b * c * w_len;
  for (int e = tid; e < cp * q_rows; e += THREADS) {
    const int ci = e / q_rows, j = e % q_rows, p = l0 - 1 + j;
    qs[j * q_ld + ci] = ci < c && p >= 0 && p < w_len ? qb[(size_t)ci * w_len + p]
                                                      : from_float<T>(0.f);
  }
  __syncthreads();

  // layer 1: [he[r]; ho[r]] (rows m: he channel m < C1P, ho channel m - C1P;
  // ho[r] = h[2r - 1]) = W1' . [q[r-1]; q[r]] for columns n, r = l0 + n;
  // W1'[m][k]: k < CP q[r-1]'s channel k, else q[r]'s channel k - CP; taps
  // he: 3 then 1, ho: 2 then 0 (ops/deconv_stem.py phase_operands)
  {
    const int mt1 = c1p / 8, nt1 = tile / 8 + 1, nq1 = (nt1 + 3) / 4;
    for (int item = warp; item < mt1 * nq1; item += WARPS) {
      const int mt = item % mt1, nq = item / mt1;
      const int ma = 16 * mt + g, mb = ma + 8;
      const int half[2] = {ma >= c1p, mb >= c1p};
      const int o[2] = {ma - half[0] * c1p, mb - half[1] * c1p};
      float acc[4][4] = {};
      for (int side = 0; side < 2; ++side) {
        const T* qrow = qs + (32 * nq + g + side) * q_ld;
        const int tap[2] = {half[0] ? 2 - 2 * side : 3 - 2 * side,
                            half[1] ? 2 - 2 * side : 3 - 2 * side};
        for (int kc = 0; kc < cp; kc += KS) {
          const ARows<T> a{{w1 + ((size_t)kc * c1 + o[0]) * 4 + tap[0],
                            w1 + ((size_t)kc * c1 + o[1]) * 4 + tap[1]},
                           {o[0] < c1, o[1] < c1}, 4 * c1, kc, c};
          mma_step(acc, a, qrow + kc, q_ld, nt1 - 4 * nq, t);
        }
      }
      // + b1, ReLU, zero h[2W] (he[W]) and h[-1] (ho[0]) and past them, to
      // hE / hO[n][channel], rounded to T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * nq + j >= nt1) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float bias = o[r] < c1 ? b1[o[r]] : 0.f;
          T* hs = half[r] ? hso : hse;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 32 * nq + 8 * j + 2 * t + e, rr = l0 + n;
            const bool inside = half[r] ? (rr >= 1 && rr <= w_len) : rr < w_len;
            hs[n * h_ld + o[r]] =
                from_float<T>(inside ? fmaxf(acc[j][2 * r + e] + bias, 0.f) : 0.f);
          }
        }
      }
    }
  }
  __syncthreads();

  // K2b: h[2m] = he[m], h[2m + 1] = ho[m + 1] = hO[m - l0 + 1]
  if (hidden != nullptr) {
    for (int e = tid; e < c1 * tile; e += THREADS) {
      const int o = e / tile, n = e % tile;
      if (n < n_valid) {
        T* dst = hidden + ((size_t)b * c1 + o) * (2 * w_len) + 2 * (l0 + n);
        dst[0] = hse[n * h_ld + o];
        dst[1] = hso[(n + 1) * h_ld + o];
      }
    }
  }

  // layer 2: the packed output rows m = 4o + j over the depth k = s C1P + c1
  // of row sets s (hE[n], hO[n], hO[n + 1], hE[n + 1]); warp w takes the k
  // steps [w S / 8, (w + 1) S / 8) of the S in the depth
  {
    const int steps = 4 * c1p / KS, nt2 = tile / 8;
    const int s0 = warp * steps / WARPS, s1 = (warp + 1) * steps / WARPS;
    float acc[8][4] = {};
    for (int st = s0; st < s1; ++st) {
      const int k0 = st * KS, s = k0 / c1p, cc = k0 - s * c1p, tap = W2_TAPS[s][g & 3];
      const T* hrow = ((s == 0 || s == 3) ? hse : hso) + (g + (s >= 2)) * h_ld;
      const size_t col = (size_t)cc * C_OUT * 4 + tap;  // rows 4o + j: o = g / 4, g / 4 + 2
      const ARows<T> a{{w2 + col + (g >> 2) * 4, w2 + col + ((g >> 2) + 2) * 4},
                       {tap >= 0, tap >= 0}, C_OUT * 4, cc, c1};
      mma_step(acc, a, hrow + cc, h_ld, nt2, t);
    }
    // ps[w][m][n]: the warp's partial sums
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nt2)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ps[(warp * 16 + g + 8 * r) * tile + 8 * j + 2 * t + e] = acc[j][2 * r + e];
  }
  __syncthreads();

  // out[b][o][4 (l0 + n) + j] = ((P0 + P1) + ... + P7) + b2[o], rounded to T
  for (int e = tid; e < C_OUT * 4 * tile; e += THREADS) {
    const int o = e / (4 * tile), p = e % (4 * tile), n = p >> 2, m = 4 * o + (p & 3);
    if (n >= n_valid) continue;
    float s = ps[m * tile + n];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += ps[(w * 16 + m) * tile + n];
    out[((size_t)b * C_OUT + o) * (4 * (size_t)w_len) + 4 * l0 + p] = from_float<T>(s + b2[o]);
  }
}

// Allow a kernel `smem` bytes of dynamic shared memory; 0 or a CUDA error.
template <typename Kernel>
int allow(Kernel kernel, size_t smem, long long blocks) {
  if (smem > 232448 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// The encoder stem at widths 4 -> c1 -> c2 (any c1 >= 1, c2 >= 1), on
// fp32 (bf16 == 0) or bf16 x, w1t, w2t, out and hidden; biases fp32; hidden
// may be null (K1), otherwise it receives h1 (K1b). `tile`: output positions
// a block, 32, 64 or 128 (ops/conv_stem.py plan_stem).
extern "C" int conv_stem_any_fwd(int bf16_ops, const void* x, const void* w1t, const float* b1,
                                 const void* w2t, const float* b2, void* out, void* hidden,
                                 int batch, int t_len, int c1, int c2, int tile, void* stream) {
  if (c1 < 1 || c2 < 1 || tile % 32 || tile < 32 || t_len < 4) return (int)cudaErrorInvalidValue;
  const int c2p = round_up(c2, 16), groups = (c2p + MAX_GROUP - 1) / MAX_GROUP;
  const long long blocks = (long long)batch * ((t_len / 4 + tile - 1) / tile) * groups;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_ops) {
    const size_t smem = conv_smem<bf16>(round_up(c1, 16), tile);
    if (int e = allow(conv_stem_any_kernel<bf16>, smem, blocks)) return e;
    if (blocks == 0) return 0;
    conv_stem_any_kernel<bf16><<<(unsigned)blocks, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)w1t, b1, (const bf16*)w2t, b2, (bf16*)out, (bf16*)hidden,
        t_len, c1, c2, tile);
  } else {
    const size_t smem = conv_smem<float>(round_up(c1, 8), tile);
    if (int e = allow(conv_stem_any_kernel<float>, smem, blocks)) return e;
    if (blocks == 0) return 0;
    conv_stem_any_kernel<float><<<(unsigned)blocks, THREADS, smem, s>>>(
        (const float*)x, (const float*)w1t, b1, (const float*)w2t, b2, (float*)out,
        (float*)hidden, t_len, c1, c2, tile);
  }
  return (int)cudaGetLastError();
}

// The decoder stem at widths c -> c1 -> 4 (any c, c1 >= 1), on fp32 (bf16 ==
// 0) or bf16 q, w1, w2, out and hidden; biases fp32; hidden may be null (K2),
// otherwise it receives h (K2b). `tile`: positions of q a block, 16, 32 or
// 64 (ops/deconv_stem.py plan_stem).
extern "C" int deconv_stem_any_fwd(int bf16_ops, const void* q, const void* w1, const float* b1,
                                   const void* w2, const float* b2, void* out, void* hidden,
                                   int batch, int w_len, int c, int c1, int tile, void* stream) {
  if (c < 1 || c1 < 1 || tile % 16 || tile < 16 || tile > 64) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch * ((w_len + tile - 1) / tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_ops) {
    const size_t smem = deconv_smem<bf16>(round_up(c, 16), round_up(c1, 16), tile);
    if (int e = allow(deconv_stem_any_kernel<bf16>, smem, blocks)) return e;
    if (blocks == 0) return 0;
    deconv_stem_any_kernel<bf16><<<(unsigned)blocks, THREADS, smem, s>>>(
        (const bf16*)q, (const bf16*)w1, b1, (const bf16*)w2, b2, (bf16*)out, (bf16*)hidden,
        w_len, c, c1, tile);
  } else {
    const size_t smem = deconv_smem<float>(round_up(c, 8), round_up(c1, 8), tile);
    if (int e = allow(deconv_stem_any_kernel<float>, smem, blocks)) return e;
    if (blocks == 0) return 0;
    deconv_stem_any_kernel<float><<<(unsigned)blocks, THREADS, smem, s>>>(
        (const float*)q, (const float*)w1, b1, (const float*)w2, b2, (float*)out,
        (float*)hidden, w_len, c, c1, tile);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block of conv_stem_any_fwd (transposed == 0,
// widths (c1, c2)) or deconv_stem_any_fwd (transposed == 1, widths (c, c1))
// at a tile, fp32 (bf16 == 0) or bf16. ops/conv_stem.py and
// ops/deconv_stem.py plan_stem restate it.
extern "C" int stem_any_smem_bytes(int transposed, int bf16_ops, int wa, int wb, int tile) {
  if (transposed)
    return (int)(bf16_ops ? deconv_smem<bf16>(round_up(wa, 16), round_up(wb, 16), tile)
                          : deconv_smem<float>(round_up(wa, 8), round_up(wb, 8), tile));
  return (int)(bf16_ops ? conv_smem<bf16>(round_up(wa, 16), tile)
                        : conv_smem<float>(round_up(wa, 8), tile));
}
