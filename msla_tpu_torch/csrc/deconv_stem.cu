// Fused VQ-VAE decoder stem: convT k4 s2 p1 (128 -> 64) + ReLU, then
// convT k4 s2 p1 (64 -> 4), in one pass over device memory, on fp32 operands
// (deconv_stem_3xtf32_kernel) or, for the bf16 compute_dtype, bf16 ones (q,
// w1, w2; the biases stay fp32; deconv_stem_bf16_kernel), both on the tensor
// cores.
//
// Replaces: msla_tpu/ops/deconv_stem.py:35 _deconv_kernel (deconv_stem_pallas),
// both its forward (K2) and, with a non-null `hidden`, its save_hidden forward
// for training (K2b, the pallas_call at deconv_stem.py:132).
//
// A stride-2 transposed conv splits into two unit-stride phases,
//   out[2m]   = x[m] W1 + x[m-1] W3,     out[2m+1] = x[m] W2 + x[m+1] W0,
// so no product touches the stride-dilated input's zeros. The hidden h (B, 64,
// 2W) never reaches device memory (K2b writes it once, for the backward): a
// persistent block (one per SM, at most one a tile) keeps the first layer's
// weights in shared memory, computes h for a tile of positions plus a
// one-row halo on each side into shared memory, then the 4-channel output
// from it. Both layers are computed transposed, channels as the mma's rows
// and positions as its columns, because q is NCW (positions contiguous) and
// the first layer reads it at two shifts, q[m-1] and q[m]:
// - Layer 1: [he | ho] = W1' (128 x 256) . [q[r-1] ; q[r]] (256 x columns r),
//   where column r gives he[r] = h[2r] and ho[r-1] = h[2r-1] (the tile's h
//   plus both halo rows). W1' stacks the phase weights ([W3 W1] over [W2 W0],
//   transposed); the prologue packs it from w1 into shared memory, where it
//   stays for the block's lifetime and ldmatrix reads the A fragments. Add
//   b1, ReLU, zero the rows outside [0, 2W), then store even and odd rows of
//   h in two arrays (hsE, hsO), position-major: the second layer's four row
//   sets are then consecutive rows of one of them.
// - Layer 2: the packed output [out[4l] .. out[4l+3]] x 4 channels (16 rows)
//   from W2' (16 x 256, zero blocks included: the Pallas kernel's
//   _phase_weights_2) and [h[2l] ; h[2l-1] ; h[2l+1] ; h[2l+2]] (256 x
//   positions), ldmatrix reading hsE / hsO.
// - K2b: the tile's interior h rows go from hsE / hsO to device memory as
//   (even, odd) pairs, eight positions of four channels a warp instruction:
//   runs along W, no bank conflicts.
//
// fp32 (deconv_stem_3xtf32_kernel). Bound on an H100: at batch 64, W =
// 11,000 the stem does 4.90e10 FLOP and must move 360.4 MB in + 45.1 MB out
// (+ 360.4 MB of h for K2b): 0.121 ms (0.229 ms for K2b) by bytes at 3.35
// TB/s, 0.099 ms for the FLOP at the TF32 tensor-core peak (495 TFLOP/s),
// 0.732 ms on the fp32 FMA units (67 TFLOP/s), where the FMA kernel this
// replaces ran at 3.4x that floor. So both layers run on the tensor cores in
// 3xTF32 (tf32_split.cuh: mma.sync.m16n8k8 on hi = tf32(x), lo = tf32(x -
// hi), lo.hi + hi.lo + hi.hi a k8 step into one fp32 accumulator; one-pass
// TF32 would keep ~11 bits of each product): three products, 0.297 ms at the
// TF32 peak. The split happens in registers as each fragment is loaded (K1's
// note says why), so shared memory holds fp32 values, and still it is what
// shapes the kernel: W1' alone is 133 KB (rows padded so ldmatrix's 8 rows
// land on 32 banks) of the 232.4 KB a block may have. So the tile is TILE =
// 60 positions (64 layer-1 columns, 61 used) and q's tile is held once, not
// double-buffered (37 KB): the first layer runs over q's channels 0-63 (at
// r-1 and r), then 64-127, and each half of the next tile's q streams in by
// cp.async as soon as every warp is done with that half, the first under
// this tile's second half of products, the second under the epilogue, K2b's
// stores and layer 2.
// - Layer 1: 8 warps of 32 rows x 32 columns, 16 splits a k8 step for 24
//   products; its B fragments are 4-byte loads from q's NCW rows (padded to
//   72 floats, 32 banks), which take either shift.
// - Layer 2, transposed once more so that h is its A operand (ldmatrix from
//   hsE / hsO) and W2' its B: warp w takes positions 16 (w % 4) .. and the
//   row sets h[2l], h[2l-1] (w < 4) or h[2l+1], h[2l+2] (w >= 4), two
//   128-deep chains; the second adds its partial sums to the first's through
//   shared memory, + b2, and the first writes out[o][4l .. 4l + 3] straight
//   from its accumulators, 16 B runs along W.
// - A width W % 4 != 0 leaves q's rows unaligned for 16-byte copies; then q
//   comes by 4-byte copies, into the same buffer.
//
// bf16 (deconv_stem_bf16_kernel; the Pallas kernel's cast points,
// msla_tpu/ops/deconv_stem.py:35-63): h = relu(sum of exact bf16 products in
// fp32 + b1) is rounded to bf16 before the second layer reads it (K2b in bf16
// writes that rounded h), and the output is rounded to bf16 as it is stored.
// Bound: the same FLOP at the bf16 tensor-core peak (989 TFLOP/s) take 0.050
// ms and the 180.2 MB in + 22.5 MB out 0.061 ms (K2b in bf16 also writes 180.2
// MB of h: 0.114 ms): bound by bytes. So both layers run on mma.sync.m16n8k16
// bf16 -> fp32, whose products of bf16 values are exact, as the Pallas kernel
// runs them on the MXU, and the q tiles stream through a double buffer of
// cp.async loads that run under the previous tile's products. A B fragment
// of layer 1 gathers its two channels of one position with two 16-bit shared
// loads, which take any shift (ldmatrix would need 16-byte-aligned rows).
// - Layer 1, per tile of TILE = 120 positions: 128 columns r = m0 .. m0 + 127
//   (121 used), W1' in shared memory as 64 KB bf16; h rounded to bf16 in the
//   accumulator registers. 2 x 4 warps of 64 channels x 32 positions, 16
//   products a k16 step for 4 ldmatrix and 16 16-bit loads.
// - Layer 2: W2' is the A operand; B fragments by ldmatrix from hsE / hsO.
//   Add b2, round to bf16, stage in shared memory and store each channel's 4
//   * TILE samples coalesced.
// - A width W % 8 != 0 leaves q's rows unaligned for 16-byte copies; then the
//   tile is loaded by 16-bit loads, the same double buffer.
// The kernel runs at some 8x its bound (PERF.md): those 16-bit loads and one
// block of 8 warps an SM are the likely brakes, not measured apart. The
// tensor cores' accumulator truncates where fp32 adds round to nearest, so
// one 256-deep chain on it leaves each h value further from the plain
// version's sum, and more of them round to the other bf16 neighbour
// (chip_smoke.py counts the outputs that then move beyond 2 ulps): each half
// of the sum, q[r-1]'s 128 channels and q[r]'s, runs on the tensor cores from
// zero, and the two halves add in fp32, as the plain version adds its two
// taps' products.
//
// fp32 at the sweep's other widths, num_hidden 64 and 256 of
// configs/hparams_search/optuna.yaml: (C, C1) = (64, 32) is the 3xTF32
// kernel above at those widths (deconv_stem_3xtf32_kernel<64, 32>: W1' 33.8
// KB; layer 1's 8 warps of 32 rows x 16 columns). It holds W1' whole in
// shared memory, 528 KB at C = 256, so that width runs
// deconv_stem_fma_kernel<256, 128>: a plain fp32 kernel on the FMA units
// (each product and add exact fp32 FMA, no tensor core), one block a tile of
// TM =
// 63 positions of q: layer 1 into hsE[a] = h[2(m0 + a)] and hsO[a] = h[2(m0 +
// a) - 1], a = 0 .. 63 (the tile's h and both halo rows, zero outside [0,
// 2W)), from the tile's q window (C x 65 floats), streaming w1 through
// shared memory in chunks of 32 input channels (C1 x 4 floats each: 64 KB at
// C1 = 128); a warp takes C1 / 8 channels, a lane 2 positions, both phases
// (each sums c in ascending order, two FMAs a channel, from zero; + b1,
// ReLU). Layer 2 (the 4 output channels, 16 products of 2 C1 terms a
// position) takes a thread an (o, position), out[o][4m .. 4m + 3] one 16-byte
// store. Bound at batch 32, W = 11,000, (256, 128): 9.37e10 FLOP, 1.40 ms on
// the FMA units, against 360.4 MB in + 22.5 MB out (+ 360.4 MB of h): 0.114
// ms; bound by the FMA units (3xTF32 on the tensor cores: 0.57 ms for its
// three products). K2b writes h from hsE / hsO.
//
// Layouts (NCW, as torch): q (B, 128, W), out (B, 4, 4W), hidden (B, 64, 2W)
// (C and C1 at the other widths).
// Weights in torch's ConvTranspose1d layout (in, out, k): w1 (128, 64, 4),
// w2 (64, 4, 4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int CI = 128;               // input channels
constexpr int C1 = 64;                // hidden channels
constexpr int CO = 4;                 // output channels
constexpr int M1 = 2 * C1;            // layer-1 rows: he channels, then ho channels
constexpr int K1 = 2 * CI;            // layer-1 depth: q[r-1], then q[r]
constexpr int M2 = 4 * CO;            // layer-2 rows: out[4l + j] of channel o at row 4o + j
constexpr int K2 = 4 * C1;            // layer-2 depth: h[2l], h[2l-1], h[2l+1], h[2l+2]
constexpr int THREADS = 256;          // 8 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Tap of w2 that multiplies row set g (0: h[2l], 1: h[2l-1], 2: h[2l+1],
// 3: h[2l+2]) into out[4l + j], or -1 for a zero block (_phase_weights_2).
__device__ __forceinline__ int w2_tap(int g, int j) {
  switch (g) {
    case 0: return j < 3 ? j + 1 : -1;
    case 1: return j == 0 ? 3 : -1;
    case 2: return j > 0 ? j - 1 : -1;
    default: return j == 3 ? 0 : -1;
  }
}

// ---- fp32 in 3xTF32 on the tensor cores --------------------------------------

namespace tf32_mma {

constexpr int TILE = 60;              // positions per tile (a multiple of 4: 16-byte q rows)
constexpr int N1 = 64;                // layer-1 columns r = m0 .. m0 + 63 (TILE + 1 used)
constexpr int NQ = N1 + 8;            // q positions m0 - 4 .. m0 + 67 (B loads on 32 banks)
constexpr int H_ROWS = N1 + 8;        // layer 2 reads rows up to N1; the last 8 stay zero
constexpr int P_LD = M2 + 8;          // floats a row of the second chain's partial sums

// The widths' layout: NC -> NC1 -> 4, instantiated at the default (128, 64)
// and at (64, 32), where W1' is a quarter the size.
template <int NC, int NC1>
struct Layout {
  static constexpr int M1 = 2 * NC1;    // layer-1 rows: he channels, then ho channels
  static constexpr int K1 = 2 * NC;     // layer-1 depth: q[r-1], then q[r]
  static constexpr int K2 = 4 * NC1;    // layer-2 depth: h[2l], h[2l-1], h[2l+1], h[2l+2]
  static constexpr int HALF = NC / 2;   // q's channels a cp.async group carries
  static constexpr int W1_LD = K1 + 4;  // floats a row of W1' (1,040 B at the default:
                                        // ldmatrix rows on 32 banks)
  static constexpr int H_LD = NC1 + 4;  // floats a row of hsE / hsO (272 B at the default)
  static constexpr int W2_LD = K2 + 4;  // floats a row of W2' (B loads on 32 banks)
  // layer 1's warps: WM rows of 32 (of M1) by WN columns of CW (of N1)
  static constexpr int WM = M1 / 32, WN = (THREADS / 32) / WM, CW = N1 / WN;
  static constexpr int WN_LOG2 = WN == 8 ? 3 : WN == 4 ? 2 : WN == 2 ? 1 : 0;
  // shared memory, in bytes from the start
  static constexpr int W1S = 0;
  static constexpr int QS = W1S + M1 * W1_LD * 4;           // q's tile [NC][NQ]
  static constexpr int HSE = QS + NC * NQ * 4;              // hsE[i] = h[2(m0 + i)]
  static constexpr int HSO = HSE + H_ROWS * H_LD * 4;       // hsO[i] = h[2(m0 + i) - 1]
  static constexpr int W2S = HSO + H_ROWS * H_LD * 4;       // [M2][W2_LD]
  static constexpr int PS = W2S + M2 * W2_LD * 4;           // [N1][P_LD]
  static constexpr int B1S = PS + N1 * P_LD * 4;
  static constexpr int B2S = B1S + NC1 * 4;
  static constexpr int SMEM_BYTES = B2S + CO * 4;           // 232,208 at the default
  static_assert(M1 % 32 == 0 && CW % 8 == 0 && HALF % 8 == 0 && (1 << WN_LOG2) == WN,
                "layer 1's warp tiles");
};

template <int NC, int NC1>
__global__ void __launch_bounds__(THREADS, 1)
deconv_stem_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, float* __restrict__ out,
                          float* __restrict__ hidden, int batch, int width) {
  using L = Layout<NC, NC1>;
  constexpr int CI = NC, C1 = NC1, M1 = L::M1, K1 = L::K1, K2 = L::K2, HALF = L::HALF;
  constexpr int W1_LD = L::W1_LD, H_LD = L::H_LD, W2_LD = L::W2_LD, CW = L::CW;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* w1s = reinterpret_cast<float*>(smem + L::W1S);
  float* qs = reinterpret_cast<float*>(smem + L::QS);
  float* hse = reinterpret_cast<float*>(smem + L::HSE);
  float* hso = reinterpret_cast<float*>(smem + L::HSO);
  float* w2s = reinterpret_cast<float*>(smem + L::W2S);
  float* ps = reinterpret_cast<float*>(smem + L::PS);
  float* b1s = reinterpret_cast<float*>(smem + L::B1S);
  float* b2s = reinterpret_cast<float*>(smem + L::B2S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // W1'[n][k]: row n < 64 is he channel n, row 64 + o is ho channel o; column
  // k < 128 multiplies q[r-1] channel k, column 128 + c q[r] channel c:
  // he[r] = q[r-1] W3 + q[r] W1, ho[r-1] = q[r-1] W2 + q[r] W0.
  for (int i = tid; i < M1 * K1; i += THREADS) {
    const int n = i / K1, k = i % K1, c = k % CI, later = k / CI, o = n % C1;
    const int tap = n < C1 ? (later ? 1 : 3) : (later ? 0 : 2);
    w1s[n * W1_LD + k] = w1[(c * C1 + o) * 4 + tap];
  }
  for (int i = tid; i < M2 * K2; i += THREADS) {  // W2'[4o + j][64 set + c]
    const int n = i / K2, k = i % K2, tap = w2_tap(k / C1, n % 4);
    w2s[n * W2_LD + k] = tap < 0 ? 0.f : w2[((k % C1) * CO + n / 4) * 4 + tap];
  }
  for (int i = tid; i < (H_ROWS - N1) * H_LD; i += THREADS) {
    hse[N1 * H_LD + i] = 0.f;
    hso[N1 * H_LD + i] = 0.f;
  }
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < CO; i += THREADS) b2s[i] = b2[i];

  const int tiles_per_row = (width + TILE - 1) / TILE;
  const long long total = (long long)batch * tiles_per_row;
  // qs[ch][u] holds position m0 - 4 + u of channel ch, zero outside [0, W);
  // one cp.async group a half of the channels
  const bool aligned = width % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  auto load_q = [&](long long tile, int half) {
    if (tile < total) {
      const int b = (int)(tile / tiles_per_row), m0 = (int)(tile % tiles_per_row) * TILE;
      const float* qb = q + ((size_t)b * CI + half * HALF) * width;
      float* dst = qs + half * HALF * NQ;
      if (aligned) {  // whole 16-byte chunks, each inside [0, W) or outside it
        for (int i = tid; i < HALF * (NQ / 4); i += THREADS) {
          const int ch = i / (NQ / 4), u = 4 * (i % (NQ / 4)), m = m0 - 4 + u;
          const bool valid = m >= 0 && m < width;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           smem_addr(dst + ch * NQ + u)),
                       "l"(qb + (size_t)ch * width + (valid ? m : 0)), "r"(valid ? 16 : 0));
        }
      } else {  // rows not 16-byte aligned: 4-byte copies
        for (int i = tid; i < HALF * NQ; i += THREADS) {
          const int ch = i / NQ, u = i % NQ, m = m0 - 4 + u;
          const bool valid = m >= 0 && m < width;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                           smem_addr(dst + ch * NQ + u)),
                       "l"(qb + (size_t)ch * width + (valid ? m : 0)), "r"(valid ? 4 : 0));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  long long tile = blockIdx.x;
  load_q(tile, 0);
  load_q(tile, 1);
  for (; tile < total; tile += gridDim.x) {
    const int b = (int)(tile / tiles_per_row), m0 = (int)(tile % tiles_per_row) * TILE;
    const long long next = tile + gridDim.x;

    // layer 1: warp (wm, wn) takes rows 32 wm .. (he for 32 wm < C1, ho
    // after) x columns CW wn .. (CW = 32 at the default widths, 16 at (64,
    // 32)); k8 steps over q's channels 0-63 at r-1 and at r, then 64-127 at
    // r-1 and at r (the halves of C)
    const int wm = warp >> L::WN_LOG2, wn = warp & (L::WN - 1);
    float acc[2][CW / 8][4] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // half 0: its channels are in, and the previous tile's readers of hsE,
      // hsO and the partial sums are done; half 1: its channels are in, and
      // every warp is done with half 0, whose buffer the next tile then fills
      if (half == 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (half == 1) load_q(next, 0);
#pragma unroll 4
      for (int s = 0; s < 2 * HALF / 8; ++s) {
        const int later = s / (HALF / 8), ch0 = half * HALF + 8 * (s % (HALF / 8));
        const int k0 = later * CI + ch0;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t r[4];
          ldsm_x4(r, w1s + (32 * wm + 16 * mi + (lane & 15)) * W1_LD + k0 + (lane >> 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(r[e], ah[mi][e], al[mi][e]);
        }
        // column r = m0 + lambda reads q[r - 1] at u = lambda + 3, q[r] at lambda + 4
        const float* col = qs + (ch0 + t) * NQ + CW * wn + g + 3 + later;
#pragma unroll
        for (int ni = 0; ni < CW / 8; ++ni) {
          uint32_t bh0, bl0, bh1, bl1;
          split(__float_as_uint(col[8 * ni]), bh0, bl0);
          split(__float_as_uint(col[8 * ni + 4 * NQ]), bh1, bl1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // every warp is done with q
    load_q(next, 1);

    // + b1, ReLU, zero outside [0, 2W) (he[r]: r < W; ho[r-1]: 1 <= r <= W)
    {
      const bool he = 32 * wm < C1;
      float* hs = he ? hse : hso;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < CW / 8; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = (32 * wm + 16 * mi + g + 8 * (i >> 1)) % C1;
            const int lam = CW * wn + 8 * ni + 2 * t + (i & 1), r = m0 + lam;
            const bool inside = he ? r < width : (r >= 1 && r <= width);
            hs[lam * H_LD + c] = inside ? fmaxf(acc[mi][ni][i] + b1s[c], 0.f) : 0.f;
          }
    }
    __syncthreads();

    if (hidden != nullptr) {  // K2b: h[2(m0 + i)], h[2(m0 + i) + 1] of channel c
      for (int blk = warp; blk < (N1 / 8) * (C1 / 4); blk += THREADS / 32) {
        const int i = 8 * (blk / (C1 / 4)) + (lane & 7);
        const int c = 4 * (blk % (C1 / 4)) + (lane >> 3);
        if (i < TILE && m0 + i < width)
          *reinterpret_cast<float2*>(hidden + ((size_t)b * C1 + c) * 2 * width + 2 * (m0 + i)) =
              make_float2(hse[i * H_LD + c], hso[(i + 1) * H_LD + c]);
      }
    }

    // layer 2: out^T (positions x 16) = [h[2l]; h[2l-1]; h[2l+1]; h[2l+2]]^T .
    // W2'^T; warp w takes positions 16 (w % 4) .. and row sets 2 (w / 4), + 1
    {
      const int l0 = 16 * (warp & 3), k_half = warp >> 2;
      float acc2[2][4] = {};
#pragma unroll 4
      for (int k0 = k_half * K2 / 2; k0 < (k_half + 1) * K2 / 2; k0 += 8) {
        // row set 0: h[2l] = hsE[l], 1: h[2l-1] = hsO[l], 2: hsO[l+1], 3: hsE[l+1]
        const int set = k0 / C1;
        const float* hs = (set == 0 || set == 3) ? hse : hso;
        uint32_t r[4], ah[4], al[4];
        ldsm_x4(r, hs + (l0 + (lane & 15) + (set >= 2)) * H_LD + k0 % C1 + (lane >> 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(r[e], ah[e], al[e]);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const float* wrow = w2s + (8 * ni + g) * W2_LD + k0 + t;
          uint32_t bh0, bl0, bh1, bl1;
          split(__float_as_uint(wrow[0]), bh0, bl0);
          split(__float_as_uint(wrow[4]), bh1, bl1);
          mma_3xtf32(acc2[ni], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      if (k_half == 1) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
            *reinterpret_cast<float2*>(ps + (l0 + g + 8 * r2) * P_LD + 8 * ni + 2 * t) =
                make_float2(acc2[ni][2 * r2], acc2[ni][2 * r2 + 1]);
      }
      __syncthreads();
      if (k_half == 0) {  // out[o][4l + j], j = 2 (t % 2), + 1: o = 2 ni + t / 2
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int l = l0 + g + 8 * r2, o = 2 * ni + (t >> 1);
            if (l < TILE && m0 + l < width) {
              const float2 p =
                  *reinterpret_cast<const float2*>(ps + l * P_LD + 8 * ni + 2 * t);
              *reinterpret_cast<float2*>(out + ((size_t)b * CO + o) * 4 * width +
                                         4 * (m0 + l) + 2 * (t & 1)) =
                  make_float2(acc2[ni][2 * r2] + p.x + b2s[o],
                              acc2[ni][2 * r2 + 1] + p.y + b2s[o]);
            }
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tf32_mma

// ---- bf16 on the tensor cores ------------------------------------------------

namespace bf16_mma {

constexpr int TILE = 120;             // positions per tile (a multiple of 8)
constexpr int N1 = 128;               // layer-1 columns r = m0 .. m0 + 127 (TILE + 1 used)
constexpr int NQ = N1 + 8;            // q positions in shared memory: m0 - 8 .. m0 + 127
constexpr int W1_LD = K1 + 8;         // bf16 a row of W1' (528 B: ldmatrix rows on 32 banks)
constexpr int H_LD = C1 + 8;          // bf16 a row of hsE / hsO (144 B)
constexpr int H_ROWS = N1 + 8;        // layer 2 reads rows up to N1; the last 8 stay zero
constexpr int W2_LD = K2 + 8;
constexpr int O_LD = 4 * TILE + 8;    // bf16 a staged output channel
// k16 steps a partial sum runs on the tensor cores: q[r-1]'s 128 channels,
// then q[r]'s, added in fp32 registers (see the note at the top)
constexpr int PROMOTE = 8;

// shared memory, in bytes from the start
constexpr int W1S = 0;
constexpr int QS = W1S + M1 * W1_LD * 2;          // two q buffers [CI][NQ]
constexpr int HSE = QS + 2 * CI * NQ * 2;         // hsE[i] = h[2(m0 + i)]
constexpr int HSO = HSE + H_ROWS * H_LD * 2;      // hsO[i] = h[2(m0 + i) - 1]
constexpr int W2S = HSO + H_ROWS * H_LD * 2;
constexpr int OS = W2S + M2 * W2_LD * 2;          // [CO][O_LD]
constexpr int B1S = OS + CO * O_LD * 2;
constexpr int B2S = B1S + C1 * 4;
constexpr int SMEM_BYTES = B2S + CO * 4;          // 189,008

using bf16 = __nv_bfloat16;

// c += a . b over one m16n8k16 tile: bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a . b over one m16n8k16 tile, from zero accumulators.
__device__ __forceinline__ void mma_first(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__global__ void __launch_bounds__(THREADS, 1)
deconv_stem_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, bf16* __restrict__ out,
                        bf16* __restrict__ hidden, int batch, int width) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* w1s = reinterpret_cast<bf16*>(smem + W1S);
  bf16* qbuf = reinterpret_cast<bf16*>(smem + QS);
  bf16* hse = reinterpret_cast<bf16*>(smem + HSE);
  bf16* hso = reinterpret_cast<bf16*>(smem + HSO);
  bf16* w2s = reinterpret_cast<bf16*>(smem + W2S);
  bf16* os = reinterpret_cast<bf16*>(smem + OS);
  float* b1s = reinterpret_cast<float*>(smem + B1S);
  float* b2s = reinterpret_cast<float*>(smem + B2S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // W1'[n][k]: row n < 64 is he channel n, row 64 + o is ho channel o; column
  // k < 128 multiplies q[r-1] channel k, column 128 + c q[r] channel c:
  // he[r] = q[r-1] W3 + q[r] W1, ho[r-1] = q[r-1] W2 + q[r] W0.
  for (int i = tid; i < M1 * K1; i += THREADS) {
    const int n = i / K1, k = i % K1, c = k % CI, later = k / CI, o = n % C1;
    const int tap = n < C1 ? (later ? 1 : 3) : (later ? 0 : 2);
    w1s[n * W1_LD + k] = w1[(c * C1 + o) * 4 + tap];
  }
  for (int i = tid; i < M2 * K2; i += THREADS) {  // W2'[4o + j][64 set + c]
    const int n = i / K2, k = i % K2, tap = w2_tap(k / C1, n % 4);
    w2s[n * W2_LD + k] = tap < 0 ? zero : w2[((k % C1) * CO + n / 4) * 4 + tap];
  }
  for (int i = tid; i < (H_ROWS - N1) * H_LD; i += THREADS) {
    hse[N1 * H_LD + i] = zero;
    hso[N1 * H_LD + i] = zero;
  }
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < CO; i += THREADS) b2s[i] = b2[i];

  const int tiles_per_row = (width + TILE - 1) / TILE;
  const long long total = (long long)batch * tiles_per_row;
  // qs column u holds position m0 - 8 + u of every channel, zero outside [0, W)
  auto load_q = [&](long long tile, bf16* qs) {
    const int b = (int)(tile / tiles_per_row), m0 = (int)(tile % tiles_per_row) * TILE;
    const bf16* qb = q + (size_t)b * CI * width;
    if (width % 8 == 0) {  // whole 16-byte chunks, each inside [0, W) or outside it
      for (int i = tid; i < CI * (NQ / 8); i += THREADS) {
        const int ch = i / (NQ / 8), u = 8 * (i % (NQ / 8)), m = m0 - 8 + u;
        const bool valid = m >= 0 && m < width;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(qs + ch * NQ + u)),
                     "l"(qb + (size_t)ch * width + (valid ? m : 0)), "r"(valid ? 16 : 0));
      }
    } else {  // rows not 16-byte aligned: 16-bit loads
      for (int i = tid; i < CI * NQ; i += THREADS) {
        const int ch = i / NQ, u = i % NQ, m = m0 - 8 + u;
        qs[i] = (m >= 0 && m < width) ? qb[(size_t)ch * width + m] : zero;
      }
    }
  };

  long long tile = blockIdx.x;
  if (tile < total) load_q(tile, qbuf);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < total; tile += gridDim.x, ++it) {
    const int b = (int)(tile / tiles_per_row), m0 = (int)(tile % tiles_per_row) * TILE;
    const bf16* qs = qbuf + (it & 1) * CI * NQ;
    if (tile + gridDim.x < total) load_q(tile + gridDim.x, qbuf + ((it + 1) & 1) * CI * NQ);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's q is in
    __syncthreads();  // for every thread; the weights too, on the first tile

    // layer 1: warp (wm, wn) takes rows 64 wm .. (he or ho) x columns 32 wn ..
    {
      const int wm = warp >> 2, wn = warp & 3;
      const unsigned short* q16 = reinterpret_cast<const unsigned short*>(qs);
      float acc[4][4][4];
#pragma unroll
      for (int kb = 0; kb < K1; kb += 16 * PROMOTE) {
        float part[4][4][4];
#pragma unroll
        for (int k0 = kb; k0 < kb + 16 * PROMOTE; k0 += 16) {
          uint32_t a[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            ldsm_x4(a[mi], w1s + (64 * wm + 16 * mi + (lane & 15)) * W1_LD + k0 +
                               (lane >> 4) * 8);
          // column r = m0 + lambda reads q[r - 1] (k0 < 128) or q[r] at u = lambda + 7 (+ 1)
          const unsigned short* col =
              q16 + ((k0 % CI) + 2 * t) * NQ + 32 * wn + g + 7 + k0 / CI;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const unsigned short* c = col + 8 * ni;
            const uint32_t b0 = c[0] | ((uint32_t)c[NQ] << 16);
            const uint32_t bb = c[8 * NQ] | ((uint32_t)c[9 * NQ] << 16);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
              if (k0 == kb) mma_first(part[mi][ni], a[mi], b0, bb);
              else mma(part[mi][ni], a[mi], b0, bb);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mi][ni][i] = kb == 0 ? part[mi][ni][i] : acc[mi][ni][i] + part[mi][ni][i];
      }
      // + b1, ReLU, zero outside [0, 2W) (he[r]: r < W; ho[r-1]: 1 <= r <= W), bf16
      bf16* hs = wm ? hso : hse;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 16 * mi + g + 8 * (i >> 1);
            const int lam = 32 * wn + 8 * ni + 2 * t + (i & 1), r = m0 + lam;
            const bool inside = wm ? (r >= 1 && r <= width) : r < width;
            hs[lam * H_LD + c] =
                __float2bfloat16_rn(inside ? fmaxf(acc[mi][ni][i] + b1s[c], 0.f) : 0.f);
          }
    }
    __syncthreads();

    if (hidden != nullptr) {  // K2b: h[2(m0 + i)], h[2(m0 + i) + 1] of channels c, c + 1
      for (int blk = warp; blk < (TILE / 8) * (C1 / 8); blk += THREADS / 32) {
        const int i = 8 * (blk / (C1 / 8)) + (lane & 7);
        const int c = 2 * (4 * (blk % (C1 / 8)) + (lane >> 3));
        if (m0 + i < width) {
          const uint32_t e = *reinterpret_cast<const uint32_t*>(hse + i * H_LD + c);
          const uint32_t d = *reinterpret_cast<const uint32_t*>(hso + (i + 1) * H_LD + c);
          bf16* dst = hidden + ((size_t)b * C1 + c) * 2 * width + 2 * (m0 + i);
          *reinterpret_cast<uint32_t*>(dst) = (e & 0xffffu) | (d << 16);
          *reinterpret_cast<uint32_t*>(dst + 2 * width) = (e >> 16) | (d & 0xffff0000u);
        }
      }
    }

    // layer 2: warp w takes positions 16 w .. 16 w + 15 (two n8 tiles)
    {
      const int lam0 = 16 * warp;
      float acc[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < K2; k0 += 16) {
        // row set 0: h[2l] = hsE[l], 1: h[2l-1] = hsO[l], 2: hsO[l+1], 3: hsE[l+1]
        const int set = k0 / C1;
        const bf16* hs = (set == 0 || set == 3) ? hse : hso;
        uint32_t a[4], bf[4];
        ldsm_x4(a, w2s + (lane & 15) * W2_LD + k0 + (lane >> 4) * 8);
        ldsm_x4(bf, hs + (lam0 + (lane >> 4) * 8 + (lane & 7) + (set >= 2)) * H_LD + k0 % C1 +
                        ((lane >> 3) & 1) * 8);
        mma(acc[0], a, bf[0], bf[1]);
        mma(acc[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = g + 8 * (i >> 1), o = n >> 2;
          const int lam = lam0 + 8 * ni + 2 * t + (i & 1);
          if (lam < TILE)
            os[o * O_LD + 4 * lam + (n & 3)] = __float2bfloat16_rn(acc[ni][i] + b2s[o]);
        }
    }
    __syncthreads();

    // out[b][o][4 (m0 + lam) .. + 3], 8 bytes a thread, coalesced along W
    for (int i = tid; i < CO * TILE; i += THREADS) {
      const int o = i / TILE, lam = i % TILE;
      if (m0 + lam < width)
        *reinterpret_cast<uint2*>(out + ((size_t)b * CO + o) * 4 * width + 4 * (m0 + lam)) =
            *reinterpret_cast<const uint2*>(os + o * O_LD + 4 * lam);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace bf16_mma

// ---- fp32 on the FMA units, at the sweep's other widths ----------------------

namespace fp32_fma {

constexpr int TM = 63;                // positions of q a tile
constexpr int NA = TM + 1;            // rows a of hsE / hsO: the tile's h and both halo rows
constexpr int Q_LD = TM + 2 + 3;      // floats a channel of q's window: q[m0 - 1 .. m0 + TM]
constexpr int H_LD = NA + 4;
constexpr int CCH = 32;               // input channels a chunk of w1

template <int NC, int NC1>
constexpr int smem_bytes() {
  return (NC * Q_LD + 2 * NC1 * H_LD + CCH * NC1 * 4 + NC1 * CO * 4 + NC1 + CO) * 4;
}

template <int NC, int NC1>
__global__ void __launch_bounds__(THREADS)
deconv_stem_fma_kernel(const float* __restrict__ q, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       float* __restrict__ hidden, int batch, int width) {
  static_assert(NC % CCH == 0 && NC1 % 8 == 0, "chunks of 32 input channels, 8 warps");
  constexpr int RC = NC1 / 8;         // layer-1 channels a warp
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);  // [CCH][NC1][4]: a chunk of w1
  float* w2s = w1s + CCH * NC1 * 4;             // [NC1][CO][4]: w2
  float* qs = w2s + NC1 * CO * 4;               // [NC][Q_LD]: q[c][m0 - 1 + u]
  float* hse = qs + NC * Q_LD;                  // [NC1][H_LD]: hsE[a] = h[2(m0 + a)]
  float* hso = hse + NC1 * H_LD;                // hsO[a] = h[2(m0 + a) - 1]
  float* b1s = hso + NC1 * H_LD;
  float* b2s = b1s + NC1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_per_row = (width + TM - 1) / TM;
  const int b = blockIdx.x / tiles_per_row, m0 = (blockIdx.x % tiles_per_row) * TM;
  const float* qb = q + (size_t)b * NC * width;

  for (int i = tid; i < NC * (TM + 2); i += THREADS) {
    const int c = i / (TM + 2), u = i % (TM + 2), m = m0 - 1 + u;
    qs[c * Q_LD + u] = m >= 0 && m < width ? qb[(size_t)c * width + m] : 0.f;
  }
  for (int i = tid; i < NC1 * CO * 4; i += THREADS) w2s[i] = w2[i];
  for (int i = tid; i < NC1; i += THREADS) b1s[i] = b1[i];
  if (tid < CO) b2s[tid] = b2[tid];

  // layer 1: hsE[a] = q[m0 + a] W1[1] + q[m0 + a - 1] W1[3] (u = a + 1, a),
  // hsO[a] = q[m0 + a - 1] W1[2] + q[m0 + a] W1[0], summed over c
  float ev[RC][2] = {}, od[RC][2] = {};
  for (int cb = 0; cb < NC; cb += CCH) {
    __syncthreads();  // the previous chunk's readers are done (the first time: q is in)
    const float4* src = reinterpret_cast<const float4*>(w1 + (size_t)cb * NC1 * 4);
    for (int i = tid; i < CCH * NC1; i += THREADS) reinterpret_cast<float4*>(w1s)[i] = src[i];
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < CCH; ++cc) {
      const float* qc = qs + (cb + cc) * Q_LD;
      float qa[2], qn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[r] = qc[lane + 32 * r];      // q[m0 + a - 1]
        qn[r] = qc[lane + 32 * r + 1];  // q[m0 + a]
      }
#pragma unroll
      for (int k = 0; k < RC; ++k) {
        const float4 w = reinterpret_cast<const float4*>(w1s)[cc * NC1 + warp * RC + k];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ev[k][r] = fmaf(qa[r], w.w, fmaf(qn[r], w.y, ev[k][r]));
          od[k][r] = fmaf(qn[r], w.x, fmaf(qa[r], w.z, od[k][r]));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    const int c1 = warp * RC + k;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int a = lane + 32 * r, m = m0 + a;
      hse[c1 * H_LD + a] = m < width ? fmaxf(ev[k][r] + b1s[c1], 0.f) : 0.f;
      hso[c1 * H_LD + a] = m >= 1 && m <= width ? fmaxf(od[k][r] + b1s[c1], 0.f) : 0.f;
    }
  }
  __syncthreads();

  // layer 2: out[4m + j] of channel o from hsE[a], hsO[a], hsO[a + 1], hsE[a + 1]
  {
    const int o = tid / 64, a = tid % 64, m = m0 + a;
    if (a < TM && m < width) {
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
      for (int c1 = 0; c1 < NC1; ++c1) {
        const float4 w = reinterpret_cast<const float4*>(w2s)[c1 * CO + o];
        const float e0 = hse[c1 * H_LD + a], e1 = hse[c1 * H_LD + a + 1];
        const float d0 = hso[c1 * H_LD + a], d1 = hso[c1 * H_LD + a + 1];
        y0 = fmaf(d0, w.w, fmaf(e0, w.y, y0));
        y1 = fmaf(d1, w.x, fmaf(e0, w.z, y1));
        y2 = fmaf(e0, w.w, fmaf(d1, w.y, y2));
        y3 = fmaf(e1, w.x, fmaf(d1, w.z, y3));
      }
      const float bo = b2s[o];
      reinterpret_cast<float4*>(out + ((size_t)b * CO + o) * 4 * width)[m] =
          make_float4(y0 + bo, y1 + bo, y2 + bo, y3 + bo);
    }
  }

  if (hidden != nullptr) {  // K2b: h[2m] = hsE[a], h[2m + 1] = hsO[a + 1]
    for (int e = tid; e < NC1 * TM; e += THREADS) {
      const int c1 = e / TM, a = e % TM, m = m0 + a;
      if (m < width) {
        float* dst = hidden + ((size_t)b * NC1 + c1) * 2 * width + 2 * m;
        dst[0] = hse[c1 * H_LD + a];
        dst[1] = hso[c1 * H_LD + a + 1];
      }
    }
  }
}

// One block a tile.
template <int NC, int NC1>
int launch(const float* q, const float* w1, const float* b1, const float* w2, const float* b2,
           float* out, float* hidden, int batch, int width, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NC, NC1>();
  cudaError_t err = cudaFuncSetAttribute(deconv_stem_fma_kernel<NC, NC1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)batch * ((width + TM - 1) / TM);
  if (tiles == 0) return 0;
  deconv_stem_fma_kernel<NC, NC1><<<(unsigned)tiles, THREADS, smem, stream>>>(
      q, w1, b1, w2, b2, out, hidden, batch, width);
  return (int)cudaGetLastError();
}

}  // namespace fp32_fma

// One persistent block an SM (at most one a tile).
template <typename T>
int launch(void (*kernel)(const T*, const T*, const float*, const T*, const float*, T*, T*, int,
                          int),
           int smem, int threads, int tile, const T* q, const T* w1, const float* b1,
           const T* w2, const float* b2, T* out, T* hidden, int batch, int width,
           void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((width + tile - 1) / tile);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (grid == 0) return 0;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(q, w1, b1, w2, b2, out, hidden, batch,
                                                       width);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 at the sweep's widths c -> c1 -> 4: the default (128, 64) and
// (64, 32) on the tensor cores (3xTF32), (256, 128) on the FMA units; hidden
// may be null (K2); otherwise it receives h (K2b).
extern "C" int deconv_stem_fwd(const float* q, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* out,
                               float* hidden, int batch, int width, int c, int c1,
                               void* stream) {
  if (c == CI && c1 == C1)
    return launch<float>(tf32_mma::deconv_stem_3xtf32_kernel<CI, C1>,
                         tf32_mma::Layout<CI, C1>::SMEM_BYTES, THREADS, tf32_mma::TILE, q, w1,
                         b1, w2, b2, out, hidden, batch, width, stream);
  if (c == 64 && c1 == 32)
    return launch<float>(tf32_mma::deconv_stem_3xtf32_kernel<64, 32>,
                         tf32_mma::Layout<64, 32>::SMEM_BYTES, THREADS, tf32_mma::TILE, q, w1,
                         b1, w2, b2, out, hidden, batch, width, stream);
  if (c == 256 && c1 == 128)
    return fp32_fma::launch<256, 128>(q, w1, b1, w2, b2, out, hidden, batch, width,
                                      (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a block of deconv_stem_fwd at (c, c1), or -1
// where it is not compiled for them.
extern "C" int deconv_stem_smem_bytes(int c, int c1) {
  if (c == CI && c1 == C1) return tf32_mma::Layout<CI, C1>::SMEM_BYTES;
  if (c == 64 && c1 == 32) return tf32_mma::Layout<64, 32>::SMEM_BYTES;
  if (c == 256 && c1 == 128) return fp32_fma::smem_bytes<256, 128>();
  return -1;
}

// bf16 q, w1, w2 and out, fp32 biases: hidden may be null (K2 in bf16);
// otherwise it receives the bf16 h that the second layer read (K2b in bf16).
extern "C" int deconv_stem_bf16_fwd(const __nv_bfloat16* q, const __nv_bfloat16* w1,
                                    const float* b1, const __nv_bfloat16* w2, const float* b2,
                                    __nv_bfloat16* out, __nv_bfloat16* hidden, int batch,
                                    int width, void* stream) {
  return launch<__nv_bfloat16>(bf16_mma::deconv_stem_bf16_kernel, bf16_mma::SMEM_BYTES, THREADS,
                               bf16_mma::TILE, q, w1, b1, w2, b2, out,
                               hidden, batch, width, stream);
}
