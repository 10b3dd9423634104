// Fused VQ-VAE encoder stem: conv k4 s2 p1 (4 -> 64) + ReLU, then
// conv k4 s2 p1 (64 -> 128) + ReLU, in one pass over device memory, on fp32
// operands (conv_stem_3xtf32_kernel) or, for the bf16 compute_dtype, bf16 ones
// (x, w1, w2; the biases stay fp32; conv_stem_bf16_kernel), both on the
// tensor cores.
//
// Replaces: msla_tpu/ops/conv_stem.py:48 _stem_kernel (conv_stem_pallas), both
// its forward (K1) and, with a non-null `hidden`, its save_hidden forward for
// training (K1b, the pallas_call at conv_stem.py:132).
//
// Both take any T >= 4 (the last tile is ragged): out has floor(T/4) columns
// and h1 floor(T/2); when T/2 is odd, h1's last row 2*(T/4) is a real row that
// conv2's last column reads, not padding, and the last tile writes it in K1b.
// Each h1 row is written once, coalesced along W; halo and pad rows never.
// Layouts (NCW, as torch): x (B, 4, T), out (B, 128, T/4), hidden (B, 64, T/2)
// (C2 and C1 at the other widths).
// Weights arrive pre-transposed by the wrapper: w1t (4*4, 64) indexed
// [c0*4+tap][c1], w2t (64*4, 128) indexed [c1*4+tap][c2].
//
// Both kernels share one decomposition, on mma.sync:
// - Conv1, per tile of TILE = 128 output positions q0 .. q0 + 127: the rows
//   k = 0 .. 2 TILE + 1 hold h1[2 q0 - 1 + k] (the tile's h1 and both halo
//   rows) = P (rows x 16) . W1 (16 x 64), where P[k][c0*4 + tap] =
//   x[c0][2 (2 q0 - 1 + k) - 1 + tap] is conv1's window of that row: the
//   Pallas kernel's packing of 4 samples x 4 channels a row, shifted by 2
//   samples from one row to the next, so that the even and odd phases are
//   one product (the Pallas kernel's w1e, and w1oa/w1ob where its odd phase
//   straddles two packed rows). The A fragments come by scalar loads from
//   the tile's x window in shared memory, W1 from shared memory. The
//   accumulator gives a thread one row and two channels: add b1, ReLU, zero
//   the rows outside [0, T/2) (conv2's own padding) and store the pair into
//   hE[i] = h1[2 (q0 + i)] or hO[i] = h1[2 (q0 + i) - 1], position-major.
// - Conv2, transposed: [out channels] (128) = W2' (128 x 256) . [hO[i]; hE[i];
//   hO[i+1]; hE[i+1]] (256 x TILE columns i): its four taps are four 64-deep
//   row sets of the two phases at shifts 0 and 1, which ldmatrix reads
//   straight from hE / hO. W2'[c2][tap*64 + c1] = w2[c2][c1][tap] is packed
//   once a block into shared memory, rows padded so that ldmatrix's 8 rows
//   land on 32 banks. 8 warps of 64 channels x 32 positions.
// - Loads overlap compute: blocks are persistent (one an SM, at most one a
//   tile) and the next tile's x window streams in by cp.async under this
//   tile's products (narrower loads where T is not a multiple of 16 bytes).
//   K1b writes h1 from hE / hO as (h1[2i], h1[2i+1]) pairs, eight positions
//   of four channels a warp instruction (runs along W; narrower stores where
//   T/2 is odd), then the real last row where T/2 is odd.
//
// fp32 (conv_stem_3xtf32_kernel). Bound on an H100: at batch 64, T = 44,000
// the stem does 4.90e10 FLOP and must move 45.1 MB in + 360.4 MB out (+ 360.4
// MB of h1 for K1b): 0.121 ms (0.229 ms for K1b) by bytes at 3.35 TB/s, 0.099
// ms for the FLOP at the TF32 tensor-core peak (495 TFLOP/s), 0.732 ms on the
// fp32 FMA units (67 TFLOP/s). The FMA kernel this replaces ran at some 2.7x
// that FMA floor, so the products move to the tensor cores in 3xTF32
// (tf32_split.cuh: mma.sync.m16n8k8 on hi = tf32(x) and lo = tf32(x - hi),
// lo.hi + hi.lo + hi.hi a k8 step into one fp32 accumulator; plain one-pass
// TF32 would keep ~11 bits of each product), three products: 0.297 ms at the
// TF32 peak. Conv1 is one 16-deep product a row (two k8 steps); conv2 one
// 256-deep chain. The split happens in registers, as each fragment is loaded:
// the split of a W2' A fragment serves the warp's 4 n-tiles, that of an h B
// fragment its 4 m-tiles (24 splits a warp a k8 step for 48 products), and
// shared memory keeps the fp32 size: W2' (133 KB padded), two x windows (17
// KB), hE and hO (74 KB) and W1 fill 229.9 KB of the 232.4 KB a block may
// have, at TILE = 128. h1 stored split (hi and lo) would not fit beside
// them; at TILE = 64 it would, and save conv2 the B third of its splits.
// Measured instead (tools/bench_stems.py, PERF.md): the whole split costs
// about a fifth of the kernel's time, the second and third products about
// half, so that third cannot pay for halving the tile, and the split stays
// in registers. Each thread loads and splits W1's B fragments once a tile
// and holds them through conv1. The output goes from the accumulators
// straight to device memory: a warp instruction writes 8 channels x 32 B
// runs.
//
// bf16 (conv_stem_bf16_kernel; the Pallas kernel's cast points,
// msla_tpu/ops/conv_stem.py:54-80): exact bf16 products summed in fp32,
// h1 = bf16(relu(sum + b1)), conv2 on that rounded h1, out = bf16(relu(sum +
// b2)). Bound: the same FLOP at the bf16 tensor-core peak (989 TFLOP/s) take
// 0.050 ms and the 22.5 MB in + 180.2 MB out 0.061 ms (K1b also writes 180.2
// MB of h1: 0.114 ms): bound by bytes, and by the output's bytes above all.
// Both convs run on mma.sync.m16n8k16 bf16 -> fp32, whose products of bf16
// values are exact, as the MXU's are; conv1's depth is one k16 step, its A
// fragments come by 16-bit loads, and its accumulators are rounded to bf16 in
// registers before hE / hO take them. Conv2 runs 16 products a k16 step for 4
// + 2 ldmatrix. The tensor cores' accumulator truncates where fp32 adds
// round to nearest (deconv_stem.cu's note), so taps 0-1 and taps 2-3 run as
// two 128-deep partial sums, added in fp32. The output tile is staged in
// shared memory, add b2, ReLU, bf16, and goes out 16 B a thread along
// positions (16-bit stores where T/4 % 8 != 0). 154 KB of shared memory and
// 255 registers a thread (ptxas) hold one block of 8 warps an SM: TILE = 128
// at one block an SM is the shape measured; two blocks an SM would need half
// the registers.
//
// fp32 at the sweep's other widths, num_hidden 64 and 256 of
// configs/hparams_search/optuna.yaml: (C1, C2) = (32, 64) is the 3xTF32
// kernel above at those widths (conv_stem_3xtf32_kernel<32, 64>: W2' 33.8
// KB; 8 warps of 64 channels x 16 positions in conv2). That kernel holds W2'
// whole in shared memory, C2 (4 C1 + 4) 4 B: 528 KB at (128, 256), against
// the 232.4 KB a block may have. Bound at batch 32, T = 44,000, (128, 256):
// 9.52e10 FLOP, 0.192 ms at the TF32 peak (0.58 ms for 3xTF32's three
// products; 1.42 ms on the FMA units), against 22.5 MB in + 360.4 MB out
// (+ 360.4 MB of h1 for K1b): 0.114 ms (0.222 ms); bound by the products.
// conv_stem_3xtf32_groups_kernel<128, 256> runs both convs in 3xTF32 on
// mma.sync as the kernel above does, with W2' cut into groups of CG = 64
// output channels:
// - a persistent block (one an SM; blocks i, i + 4, ... take group i % 4)
//   keeps its group's rows of W2' (132 KB) in shared memory for its lifetime
//   and walks the tiles of TILE = 64 positions. It recomputes conv1 for its
//   tile: all C1 channels of the tile's h1 rows, 12.5 % more FLOP than the
//   stem's own, also on the tensor cores; a warp takes 16 channels of every
//   row tile, with W1's B fragments split once a block and held in registers.
// - Conv2 runs one chain a tap: warp (tap, wn) takes the group's 64
//   channels x 32 positions over the tap's C1 rows of the depth, the warp
//   tile of the kernel above (24 splits a k8 step for 48 products), so the
//   64 x 64 tile costs no more splits a product than the default's 128 x 128.
//   The four taps' sums go to shared memory (over hE and hO, which conv2 is
//   then done with), are added in tap order, + b2, ReLU, and stored 16 B a
//   thread along positions.
// - K1b: the blocks of group i write h1's channels i C1 / 4 .. (i + 1) C1 / 4.
// Shared memory: W2''s group 132 KB, two x windows 8.7 KB, hE and hO 76 KB
// (the partial sums 74 KB over them), biases: 217.6 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_split.cuh"

namespace {

using tf32_split::mma_3xtf32;
using tf32_split::split;

constexpr int C0 = 4;
constexpr int C1 = 64;
constexpr int C2 = 128;
constexpr int THREADS = 256;          // 8 warps
constexpr int K2D = 4 * C1;           // conv2 depth: hO[i], hE[i], hO[i+1], hE[i+1]

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- fp32 in 3xTF32 on the tensor cores --------------------------------------

namespace tf32_mma {

constexpr int TILE = 128;             // conv2 output positions per tile
constexpr int XW = 4 * TILE + 16;     // x window: samples 4 q0 - 8 .. 4 q0 + 4 TILE + 7
constexpr int KROWS = 2 * TILE + 2;   // conv1 rows k: h1[2 q0 - 1 + k]
constexpr int MT1 = (KROWS + 15) / 16;  // conv1's m16 tiles (the last one partly unused)
constexpr int W1_LD = 16 + 4;         // floats a row of W1 [c1][c0*4 + tap]: B loads on 32 banks
constexpr int H_ROWS = TILE + 8;      // conv2 reads rows 0 .. TILE

// The widths' layout: 4 -> NC1 -> NC2, instantiated at the default (64, 128)
// and at (32, 64), where W2' is a quarter the size.
template <int NC1, int NC2>
struct Layout {
  static constexpr int K2D = 4 * NC1;   // conv2 depth: hO[i], hE[i], hO[i+1], hE[i+1]
  static constexpr int W2_LD = K2D + 4; // floats a row of W2' (1,040 B at the default:
                                        // ldmatrix rows on 32 banks)
  static constexpr int H_LD = NC1 + 4;  // floats a row of hE / hO (272 B at the default)
  // conv2's warps: WM rows of 64 channels by WN columns of PW positions
  static constexpr int WM = NC2 / 64, WN = (THREADS / 32) / WM, PW = TILE / WN, NP = PW / 16;
  static constexpr int WN_LOG2 = WN == 8 ? 3 : WN == 4 ? 2 : WN == 2 ? 1 : 0;
  // shared memory, in bytes from the start
  static constexpr int W2S = 0;
  static constexpr int XS = W2S + NC2 * W2_LD * 4;          // two x windows [C0][XW]
  static constexpr int HSE = XS + 2 * C0 * XW * 4;          // hE[i] = h1[2 (q0 + i)]
  static constexpr int HSO = HSE + H_ROWS * H_LD * 4;       // hO[i] = h1[2 (q0 + i) - 1]
  static constexpr int W1S = HSO + H_ROWS * H_LD * 4;       // [NC1][W1_LD]
  static constexpr int B1S = W1S + NC1 * W1_LD * 4;
  static constexpr int B2S = B1S + NC1 * 4;
  static constexpr int SMEM_BYTES = B2S + NC2 * 4;          // 229,888 at the default
  static_assert(NC2 % 64 == 0 && NC1 % 8 == 0 && PW % 16 == 0 && (1 << WN_LOG2) == WN,
                "conv2's warp tiles");
};

template <int NC1, int NC2>
__global__ void __launch_bounds__(THREADS, 1)
conv_stem_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                        const float* __restrict__ b1, const float* __restrict__ w2t,
                        const float* __restrict__ b2, float* __restrict__ out,
                        float* __restrict__ hidden, int batch, int t_len) {
  using L = Layout<NC1, NC2>;
  constexpr int C1 = NC1, C2 = NC2, K2D = L::K2D, W2_LD = L::W2_LD, H_LD = L::H_LD;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* w2s = reinterpret_cast<float*>(smem + L::W2S);
  float* xbuf = reinterpret_cast<float*>(smem + L::XS);
  float* hse = reinterpret_cast<float*>(smem + L::HSE);
  float* hso = reinterpret_cast<float*>(smem + L::HSO);
  float* w1s = reinterpret_cast<float*>(smem + L::W1S);
  float* b1s = reinterpret_cast<float*>(smem + L::B1S);
  float* b2s = reinterpret_cast<float*>(smem + L::B2S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // W2'[c2][tap*64 + c1] = w2t[c1*4 + tap][c2]; W1[c1][c0*4 + tap] = w1t[c0*4 + tap][c1]
  for (int i = tid; i < C2 * K2D; i += THREADS) {
    const int c2 = i % C2, k = i / C2, tap = k / C1, c1 = k % C1;
    w2s[c2 * W2_LD + k] = w2t[(c1 * 4 + tap) * C2 + c2];
  }
  for (int i = tid; i < C1 * 16; i += THREADS) {
    const int c1 = i % C1, k = i / C1;
    w1s[c1 * W1_LD + k] = w1t[k * C1 + c1];
  }
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C2; i += THREADS) b2s[i] = b2[i];

  const int w1_len = t_len / 2;       // h1 rows
  const int w2_len = t_len / 4;       // output columns
  const int tiles_per_row = (w2_len + TILE - 1) / TILE;
  const long long total = (long long)batch * tiles_per_row;

  // xs[c0][u] = x[c0][4 q0 - 8 + u], zero outside [0, T)
  const bool aligned = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto load_x = [&](long long tile, float* xs) {
    const int b = (int)(tile / tiles_per_row), s0 = 4 * ((int)(tile % tiles_per_row) * TILE) - 8;
    const float* xb = x + (size_t)b * C0 * t_len;
    if (aligned) {  // whole 16-byte chunks, each inside [0, T) or outside it
      for (int i = tid; i < C0 * (XW / 4); i += THREADS) {
        const int c = i / (XW / 4), u = 4 * (i % (XW / 4)), s = s0 + u;
        const bool valid = s >= 0 && s < t_len;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(xs + c * XW + u)),
                     "l"(xb + (size_t)c * t_len + (valid ? s : 0)), "r"(valid ? 16 : 0));
      }
    } else {  // channel rows not 16-byte aligned: 4-byte copies
      for (int i = tid; i < C0 * XW; i += THREADS) {
        const int c = i / XW, u = i % XW, s = s0 + u;
        const bool valid = s >= 0 && s < t_len;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_addr(xs + c * XW + u)),
                     "l"(xb + (size_t)c * t_len + (valid ? s : 0)), "r"(valid ? 4 : 0));
      }
    }
  };

  long long tile = blockIdx.x;
  if (tile < total) load_x(tile, xbuf);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < total; tile += gridDim.x, ++it) {
    const int b = (int)(tile / tiles_per_row), q0 = (int)(tile % tiles_per_row) * TILE;
    const int n_valid = min(TILE, w2_len - q0);
    const float* xs = xbuf + (it & 1) * C0 * XW;
    if (tile + gridDim.x < total) load_x(tile + gridDim.x, xbuf + ((it + 1) & 1) * C0 * XW);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's x is in
    // for every thread; the weights too, on the first tile; and the previous
    // tile's readers of hE and hO are done
    __syncthreads();

    // conv1: warp w takes the m16 row tiles w, w + 8, ...; row k's A row is
    // x[c0][4 q0 - 3 + 2k + tap] at u = 5 + 2k + tap (rows past KROWS repeat
    // the last and are not stored). k8 step s holds c0 = 2s (columns t) and
    // 2s + 1 (columns t + 4).
    {
      // W1's B fragments, split: b0 = W1[8 ni + g][8 s + t], b1 = W1[8 ni + g][8 s + t + 4]
      uint32_t wh[C1 / 8][2][2], wl[C1 / 8][2][2];
#pragma unroll
      for (int ni = 0; ni < C1 / 8; ++ni)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split(__float_as_uint(w1s[(8 * ni + g) * W1_LD + 8 * s + 4 * e + t]), wh[ni][s][e],
                  wl[ni][s][e]);
      for (int mt = warp; mt < MT1; mt += THREADS / 32) {
        const int ka = 16 * mt + g, kb = ka + 8;
        const int ua = 5 + 2 * min(ka, KROWS - 1) + t, ub = 5 + 2 * min(kb, KROWS - 1) + t;
        float c[C1 / 8][4] = {};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t ah[4], al[4];
          split(__float_as_uint(xs[2 * s * XW + ua]), ah[0], al[0]);
          split(__float_as_uint(xs[2 * s * XW + ub]), ah[1], al[1]);
          split(__float_as_uint(xs[(2 * s + 1) * XW + ua]), ah[2], al[2]);
          split(__float_as_uint(xs[(2 * s + 1) * XW + ub]), ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < C1 / 8; ++ni)
            mma_3xtf32(c[ni], ah, al, wh[ni][s][0], wh[ni][s][1], wl[ni][s][0], wl[ni][s][1]);
        }
        // rows ka and kb have g's parity: both go to hO (even k) or hE (odd k)
        float* hs = (g & 1) ? hse : hso;
#pragma unroll
        for (int ni = 0; ni < C1 / 8; ++ni) {
          const int ch = 8 * ni + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = r ? kb : ka, j = 2 * q0 - 1 + k;
            if (k < KROWS) {
              const bool inside = j >= 0 && j < w1_len;
              *reinterpret_cast<float2*>(hs + (k >> 1) * H_LD + ch) =
                  make_float2(inside ? fmaxf(c[ni][2 * r] + b1s[ch], 0.f) : 0.f,
                              inside ? fmaxf(c[ni][2 * r + 1] + b1s[ch + 1], 0.f) : 0.f);
            }
          }
        }
      }
    }
    __syncthreads();

    if (hidden != nullptr) {  // K1b: h1[2 (q0 + i)] = hE[i], h1[2 (q0 + i) + 1] = hO[i + 1]
      const bool pairs = w1_len % 2 == 0;  // channel rows 8-byte aligned
      for (int blk = warp; blk < (TILE / 8) * (C1 / 4); blk += THREADS / 32) {
        const int i = 8 * (blk / (C1 / 4)) + (lane & 7);
        const int c = 4 * (blk % (C1 / 4)) + (lane >> 3);
        if (i < n_valid) {
          const float e = hse[i * H_LD + c], d = hso[(i + 1) * H_LD + c];
          float* dst = hidden + ((size_t)b * C1 + c) * w1_len + 2 * (q0 + i);
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(e, d);
          } else {
            dst[0] = e;
            dst[1] = d;
          }
        }
      }
      // where T/2 is odd, the row's last tile also writes h1[T/2 - 1] = hE[n_valid]
      if (w1_len % 2 == 1 && q0 + TILE >= w2_len && tid < C1)
        hidden[((size_t)b * C1 + tid) * w1_len + w1_len - 1] = hse[n_valid * H_LD + tid];
    }

    // conv2: warp (wm, wn) takes channels 64 wm .. and positions PW wn ..
    // (PW = 32 at the default widths, 16 at (32, 64))
    {
      constexpr int PW = L::PW, NP = L::NP;
      const int wm = warp >> L::WN_LOG2, wn = warp & (L::WN - 1);
      float acc[4][2 * NP][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < K2D; k0 += 8) {
        // tap k0 / 64: 0 hO[i], 1 hE[i], 2 hO[i + 1], 3 hE[i + 1]
        const int tap = k0 / C1;
        const float* hs = (tap & 1) ? hse : hso;
        // A: W2' rows 16 mi + (g, g + 8), columns k0 + (t, t + 4), as 8x4 fp32
        // tiles read as 8x8 b16 ones; B likewise from hE / hO's position rows
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t r[4];
          ldsm_x4(r, w2s + (64 * wm + 16 * mi + (lane & 15)) * W2_LD + k0 + (lane >> 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(r[e], ah[mi][e], al[mi][e]);
        }
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          uint32_t r[4], bh[4], bl[4];
          ldsm_x4(r, hs + (PW * wn + 16 * np + (lane >> 4) * 8 + (lane & 7) + (tap >> 1)) *
                              H_LD + k0 % C1 + ((lane >> 3) & 1) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(r[e], bh[e], bl[e]);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_3xtf32(acc[mi][2 * np], ah[mi], al[mi], bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(acc[mi][2 * np + 1], ah[mi], al[mi], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
      // + b2, ReLU, straight to out[b][c2][q0 + i]: a thread's two positions
      // 2t, 2t + 1 as one 8-byte store where T/4 is even
      float* ob = out + (size_t)b * C2 * w2_len + q0;
      const bool pairs = w2_len % 2 == 0;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2 * NP; ++ni)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c2 = 64 * wm + 16 * mi + g + 8 * r;
            const int i = PW * wn + 8 * ni + 2 * t;
            const float v0 = fmaxf(acc[mi][ni][2 * r] + b2s[c2], 0.f);
            const float v1 = fmaxf(acc[mi][ni][2 * r + 1] + b2s[c2], 0.f);
            float* dst = ob + (size_t)c2 * w2_len + i;
            if (pairs && i < n_valid) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              if (i < n_valid) dst[0] = v0;
              if (i + 1 < n_valid) dst[1] = v1;
            }
          }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tf32_mma

// ---- bf16 on the tensor cores ------------------------------------------------

namespace bf16_mma {

using bf16 = __nv_bfloat16;

constexpr int TILE = 128;             // conv2 output positions per tile
constexpr int XW = 4 * TILE + 16;     // x window: samples 4 q0 - 8 .. 4 q0 + 4 TILE + 7
constexpr int KROWS = 2 * TILE + 2;   // conv1 rows k: h1[2 q0 - 1 + k]
constexpr int MT1 = (KROWS + 15) / 16;  // conv1's m16 tiles (the last one partly unused)
constexpr int W1_LD = 16 + 8;         // bf16 a row of W1 [c1][c0*4 + tap] (48 B)
constexpr int W2_LD = K2D + 8;        // bf16 a row of W2' (528 B)
constexpr int H_LD = C1 + 8;          // bf16 a row of hE / hO (144 B)
constexpr int H_ROWS = TILE + 8;      // conv2 reads rows 0 .. TILE
constexpr int O_LD = TILE + 8;        // bf16 a staged output channel (272 B)
// k16 steps a partial sum runs on the tensor cores: taps 0-1, then taps 2-3,
// added in fp32 registers (see the note at the top)
constexpr int PROMOTE = 8;

// shared memory, in bytes from the start
constexpr int W2S = 0;
constexpr int XS = W2S + C2 * W2_LD * 2;          // two x windows [C0][XW]
constexpr int HSE = XS + 2 * C0 * XW * 2;         // hE[i] = h1[2 (q0 + i)]
constexpr int HSO = HSE + H_ROWS * H_LD * 2;      // hO[i] = h1[2 (q0 + i) - 1]
constexpr int OS = HSO + H_ROWS * H_LD * 2;       // [C2][O_LD]
constexpr int W1S = OS + C2 * O_LD * 2;           // [C1][W1_LD]
constexpr int B1S = W1S + C1 * W1_LD * 2;
constexpr int B2S = B1S + C1 * 4;
constexpr int SMEM_BYTES = B2S + C2 * 4;          // 153,856

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 1)
conv_stem_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                      const float* __restrict__ b1, const bf16* __restrict__ w2t,
                      const float* __restrict__ b2, bf16* __restrict__ out,
                      bf16* __restrict__ hidden, int batch, int t_len) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* w2s = reinterpret_cast<bf16*>(smem + W2S);
  bf16* xbuf = reinterpret_cast<bf16*>(smem + XS);
  bf16* hse = reinterpret_cast<bf16*>(smem + HSE);
  bf16* hso = reinterpret_cast<bf16*>(smem + HSO);
  bf16* os = reinterpret_cast<bf16*>(smem + OS);
  bf16* w1s = reinterpret_cast<bf16*>(smem + W1S);
  float* b1s = reinterpret_cast<float*>(smem + B1S);
  float* b2s = reinterpret_cast<float*>(smem + B2S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // W2'[c2][tap*64 + c1] = w2t[c1*4 + tap][c2]; W1[c1][c0*4 + tap] = w1t[c0*4 + tap][c1]
  for (int i = tid; i < C2 * K2D; i += THREADS) {
    const int c2 = i % C2, k = i / C2, tap = k / C1, c1 = k % C1;
    w2s[c2 * W2_LD + k] = w2t[(c1 * 4 + tap) * C2 + c2];
  }
  for (int i = tid; i < C1 * 16; i += THREADS) {
    const int c1 = i % C1, k = i / C1;
    w1s[c1 * W1_LD + k] = w1t[k * C1 + c1];
  }
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C2; i += THREADS) b2s[i] = b2[i];

  const int w1_len = t_len / 2;       // h1 rows
  const int w2_len = t_len / 4;       // output columns
  const int tiles_per_row = (w2_len + TILE - 1) / TILE;
  const long long total = (long long)batch * tiles_per_row;

  // xs[c0][u] = x[c0][4 q0 - 8 + u], zero outside [0, T)
  const bool aligned = t_len % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto load_x = [&](long long tile, bf16* xs) {
    const int b = (int)(tile / tiles_per_row), s0 = 4 * ((int)(tile % tiles_per_row) * TILE) - 8;
    const bf16* xb = x + (size_t)b * C0 * t_len;
    if (aligned) {  // whole 16-byte chunks, each inside [0, T) or outside it
      for (int i = tid; i < C0 * (XW / 8); i += THREADS) {
        const int c = i / (XW / 8), u = 8 * (i % (XW / 8)), s = s0 + u;
        const bool valid = s >= 0 && s < t_len;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(xs + c * XW + u)),
                     "l"(xb + (size_t)c * t_len + (valid ? s : 0)), "r"(valid ? 16 : 0));
      }
    } else {  // channel rows not 16-byte aligned: 16-bit loads
      for (int i = tid; i < C0 * XW; i += THREADS) {
        const int c = i / XW, u = i % XW, s = s0 + u;
        xs[i] = (s >= 0 && s < t_len) ? xb[(size_t)c * t_len + s] : zero;
      }
    }
  };

  long long tile = blockIdx.x;
  if (tile < total) load_x(tile, xbuf);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < total; tile += gridDim.x, ++it) {
    const int b = (int)(tile / tiles_per_row), q0 = (int)(tile % tiles_per_row) * TILE;
    const int n_valid = min(TILE, w2_len - q0);
    const bf16* xs = xbuf + (it & 1) * C0 * XW;
    if (tile + gridDim.x < total) load_x(tile + gridDim.x, xbuf + ((it + 1) & 1) * C0 * XW);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's x is in
    // for every thread; the weights too, on the first tile; and the previous
    // tile's readers of hE, hO and the staged output are done
    __syncthreads();

    // conv1: warp w takes the m16 row tiles w, w + 8, ...; row k's A row is
    // x[c0][4 q0 - 3 + 2k + tap] at u = 5 + 2k + tap (rows past KROWS repeat
    // the last and are not stored)
    {
      const unsigned short* x16 = reinterpret_cast<const unsigned short*>(xs);
      auto pair = [&](int c0, int k) {  // A[k][c0*4 + 2(t&1)], and the next tap
        const unsigned short* p = x16 + c0 * XW + 5 + 2 * min(k, KROWS - 1) + 2 * (t & 1);
        return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
      };
      for (int mt = warp; mt < MT1; mt += THREADS / 32) {
        const int ka = 16 * mt + g, kb = ka + 8;
        const uint32_t a[4] = {pair(t >> 1, ka), pair(t >> 1, kb), pair((t >> 1) + 2, ka),
                               pair((t >> 1) + 2, kb)};
        // rows ka and kb have g's parity: both go to hO (even k) or hE (odd k)
        bf16* hs = (g & 1) ? hse : hso;
#pragma unroll
        for (int ni = 0; ni < C1 / 8; ++ni) {
          const bf16* wrow = w1s + (8 * ni + g) * W1_LD + 2 * t;
          float c[4];
          mma_first(c, a, *reinterpret_cast<const uint32_t*>(wrow),
                    *reinterpret_cast<const uint32_t*>(wrow + 8));
          const int ch = 8 * ni + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = r ? kb : ka, j = 2 * q0 - 1 + k;
            if (k < KROWS) {
              const bool inside = j >= 0 && j < w1_len;
              *reinterpret_cast<uint32_t*>(hs + (k >> 1) * H_LD + ch) =
                  pack_bf16(inside ? fmaxf(c[2 * r] + b1s[ch], 0.f) : 0.f,
                            inside ? fmaxf(c[2 * r + 1] + b1s[ch + 1], 0.f) : 0.f);
            }
          }
        }
      }
    }
    __syncthreads();

    if (hidden != nullptr) {  // K1b: h1[2 (q0 + i)] = hE[i], h1[2 (q0 + i) + 1] = hO[i + 1]
      const bool pairs = w1_len % 2 == 0;  // channel rows 4-byte aligned
      for (int blk = warp; blk < (TILE / 8) * (C1 / 8); blk += THREADS / 32) {
        const int i = 8 * (blk / (C1 / 8)) + (lane & 7);
        const int c = 2 * (4 * (blk % (C1 / 8)) + (lane >> 3));
        if (i < n_valid) {
          const uint32_t e = *reinterpret_cast<const uint32_t*>(hse + i * H_LD + c);
          const uint32_t d = *reinterpret_cast<const uint32_t*>(hso + (i + 1) * H_LD + c);
          bf16* dst = hidden + ((size_t)b * C1 + c) * w1_len + 2 * (q0 + i);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(dst) = (e & 0xffffu) | (d << 16);
            *reinterpret_cast<uint32_t*>(dst + w1_len) = (e >> 16) | (d & 0xffff0000u);
          } else {
            unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
            d16[0] = (unsigned short)e;
            d16[1] = (unsigned short)d;
            d16[w1_len] = (unsigned short)(e >> 16);
            d16[w1_len + 1] = (unsigned short)(d >> 16);
          }
        }
      }
      // where T/2 is odd, the row's last tile also writes h1[T/2 - 1] = hE[n_valid]
      if (w1_len % 2 == 1 && q0 + TILE >= w2_len && tid < C1)
        hidden[((size_t)b * C1 + tid) * w1_len + w1_len - 1] = hse[n_valid * H_LD + tid];
    }

    // conv2: warp (wm, wn) takes channels 64 wm .. and positions 32 wn ..
    {
      const int wm = warp >> 2, wn = warp & 3;
      float acc[4][4][4];
#pragma unroll
      for (int kb = 0; kb < K2D; kb += 16 * PROMOTE) {
        float part[4][4][4];
#pragma unroll
        for (int k0 = kb; k0 < kb + 16 * PROMOTE; k0 += 16) {
          // tap k0 / 64: 0 hO[i], 1 hE[i], 2 hO[i + 1], 3 hE[i + 1]
          const int tap = k0 / C1;
          const bf16* hs = (tap & 1) ? hse : hso;
          uint32_t a[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            ldsm_x4(a[mi], w2s + (64 * wm + 16 * mi + (lane & 15)) * W2_LD + k0 +
                               (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bf[4];
            ldsm_x4(bf, hs + (32 * wn + 16 * np + (lane >> 4) * 8 + (lane & 7) + (tap >> 1)) *
                                 H_LD + k0 % C1 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
              if (k0 == kb) {
                mma_first(part[mi][2 * np], a[mi], bf[0], bf[1]);
                mma_first(part[mi][2 * np + 1], a[mi], bf[2], bf[3]);
              } else {
                mma(part[mi][2 * np], a[mi], bf[0], bf[1]);
                mma(part[mi][2 * np + 1], a[mi], bf[2], bf[3]);
              }
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
      // + b2, ReLU, bf16, staged as os[c2][i]
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c2 = 64 * wm + 16 * mi + g + 8 * r;
            const int i = 32 * wn + 8 * ni + 2 * t;
            *reinterpret_cast<uint32_t*>(os + c2 * O_LD + i) =
                pack_bf16(fmaxf(acc[mi][ni][2 * r] + b2s[c2], 0.f),
                          fmaxf(acc[mi][ni][2 * r + 1] + b2s[c2], 0.f));
          }
    }
    __syncthreads();

    // out[b][c2][q0 + i], 16 B a thread along positions (16-bit stores where
    // T/4 % 8 != 0, which leaves the channel rows unaligned)
    for (int u = tid; u < C2 * (TILE / 8); u += THREADS) {
      const int c2 = u / (TILE / 8), i = 8 * (u % (TILE / 8));
      if (i >= n_valid) continue;
      bf16* dst = out + ((size_t)b * C2 + c2) * w2_len + q0 + i;
      if (w2_len % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(os + c2 * O_LD + i);
      } else {
        for (int e = 0; e < 8 && i + e < n_valid; ++e) dst[e] = os[c2 * O_LD + i + e];
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace bf16_mma

// ---- fp32 in 3xTF32 at (128, 256): W2' in groups of 64 output channels -------

namespace tf32_groups {

constexpr int TILE = 64;              // conv2 output positions per tile
constexpr int CG = 64;                // output channels a block: its group of W2''s rows
constexpr int XW = 4 * TILE + 16;     // x window: samples 4 q0 - 8 .. 4 q0 + 4 TILE + 7
constexpr int KROWS = 2 * TILE + 2;   // conv1 rows k: h1[2 q0 - 1 + k]
constexpr int MT1 = (KROWS + 15) / 16;  // conv1's m16 tiles (the last one partly unused)
constexpr int H_ROWS = TILE + 8;      // conv2 reads rows 0 .. TILE
constexpr int P_LD = TILE + 8;        // floats a row of a tap's partial sums [c][i]: float2
                                      // stores and float4 loads on 32 banks

template <int NC1, int NC2>
struct Layout {
  static constexpr int GROUPS = NC2 / CG;
  static constexpr int GC1 = NC1 / GROUPS;  // h1 channels a group's blocks write (K1b)
  static constexpr int NW = NC1 / 64;   // conv1's n8 tiles a warp: channels 8 NW warp ..
  static constexpr int K2D = 4 * NC1;   // conv2 depth: hO[i], hE[i], hO[i+1], hE[i+1]
  static constexpr int W2_LD = K2D + 4; // floats a row of W2' (ldmatrix rows on 32 banks)
  static constexpr int H_LD = NC1 + 4;  // floats a row of hE / hO
  // shared memory, in bytes from the start
  static constexpr int W2S = 0;                             // [CG][W2_LD]: the group's rows
  static constexpr int XS = W2S + CG * W2_LD * 4;           // two x windows [C0][XW]
  static constexpr int HSE = XS + 2 * C0 * XW * 4;          // hE[i] = h1[2 (q0 + i)]
  static constexpr int HSO = HSE + H_ROWS * H_LD * 4;       // hO[i] = h1[2 (q0 + i) - 1]
  static constexpr int PS = HSE;                            // [4][CG][P_LD]: the taps' sums
  static constexpr int B1S = HSO + H_ROWS * H_LD * 4;
  static constexpr int B2S = B1S + NC1 * 4;                 // the group's b2
  static constexpr int SMEM_BYTES = B2S + CG * 4;           // 217,600 at (128, 256)
  static_assert(NC2 % CG == 0 && NC1 % 64 == 0 && GC1 % 4 == 0, "conv1's and K1b's warps");
  static_assert(4 * CG * P_LD <= 2 * H_ROWS * H_LD, "the partial sums fit over hE and hO");
};

template <int NC1, int NC2>
__global__ void __launch_bounds__(THREADS, 1)
conv_stem_3xtf32_groups_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                               const float* __restrict__ b1, const float* __restrict__ w2t,
                               const float* __restrict__ b2, float* __restrict__ out,
                               float* __restrict__ hidden, int batch, int t_len) {
  using L = Layout<NC1, NC2>;
  constexpr int C1 = NC1, C2 = NC2, K2D = L::K2D, W2_LD = L::W2_LD, H_LD = L::H_LD;
  constexpr int NW = L::NW, GC1 = L::GC1;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* w2s = reinterpret_cast<float*>(smem + L::W2S);
  float* xbuf = reinterpret_cast<float*>(smem + L::XS);
  float* hse = reinterpret_cast<float*>(smem + L::HSE);
  float* hso = reinterpret_cast<float*>(smem + L::HSO);
  float* ps = reinterpret_cast<float*>(smem + L::PS);
  float* b1s = reinterpret_cast<float*>(smem + L::B1S);
  float* b2s = reinterpret_cast<float*>(smem + L::B2S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = blockIdx.x % L::GROUPS, c2_0 = CG * group;  // this block's channels

  // W2'[c][tap*C1 + c1] = w2t[c1*4 + tap][c2_0 + c], the group's CG rows
  for (int i = tid; i < CG * K2D; i += THREADS) {
    const int c = i % CG, k = i / CG, tap = k / C1, c1 = k % C1;
    w2s[c * W2_LD + k] = w2t[(c1 * 4 + tap) * C2 + c2_0 + c];
  }
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < CG; i += THREADS) b2s[i] = b2[c2_0 + i];
  // W1's B fragments of the warp's channels ch = 8 (NW warp + ni) + g, split
  // once: b0 = W1[ch][8 s + t], b1 = W1[ch][8 s + t + 4], W1[c1][c0*4 + tap] =
  // w1t[c0*4 + tap][c1]
  uint32_t wh[NW][2][2], wl[NW][2][2];
#pragma unroll
  for (int ni = 0; ni < NW; ++ni)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split(__float_as_uint(w1t[(8 * s + 4 * e + t) * C1 + 8 * (NW * warp + ni) + g]),
              wh[ni][s][e], wl[ni][s][e]);

  const int w1_len = t_len / 2;       // h1 rows
  const int w2_len = t_len / 4;       // output columns
  const int tiles_per_row = (w2_len + TILE - 1) / TILE;
  const long long total = (long long)batch * tiles_per_row;
  const int stride = gridDim.x / L::GROUPS;  // the group's blocks

  // xs[c0][u] = x[c0][4 q0 - 8 + u], zero outside [0, T)
  const bool aligned = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto load_x = [&](long long tile, float* xs) {
    const int b = (int)(tile / tiles_per_row), s0 = 4 * ((int)(tile % tiles_per_row) * TILE) - 8;
    const float* xb = x + (size_t)b * C0 * t_len;
    if (aligned) {  // whole 16-byte chunks, each inside [0, T) or outside it
      for (int i = tid; i < C0 * (XW / 4); i += THREADS) {
        const int c = i / (XW / 4), u = 4 * (i % (XW / 4)), s = s0 + u;
        const bool valid = s >= 0 && s < t_len;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(xs + c * XW + u)),
                     "l"(xb + (size_t)c * t_len + (valid ? s : 0)), "r"(valid ? 16 : 0));
      }
    } else {  // channel rows not 16-byte aligned: 4-byte copies
      for (int i = tid; i < C0 * XW; i += THREADS) {
        const int c = i / XW, u = i % XW, s = s0 + u;
        const bool valid = s >= 0 && s < t_len;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_addr(xs + c * XW + u)),
                     "l"(xb + (size_t)c * t_len + (valid ? s : 0)), "r"(valid ? 4 : 0));
      }
    }
  };

  long long tile = blockIdx.x / L::GROUPS;
  if (tile < total) load_x(tile, xbuf);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < total; tile += stride, ++it) {
    const int b = (int)(tile / tiles_per_row), q0 = (int)(tile % tiles_per_row) * TILE;
    const int n_valid = min(TILE, w2_len - q0);
    const float* xs = xbuf + (it & 1) * C0 * XW;
    if (tile + stride < total) load_x(tile + stride, xbuf + ((it + 1) & 1) * C0 * XW);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's x is in
    // for every thread; the weights too, on the first tile; and the previous
    // tile's readers of the partial sums (over hE and hO) are done
    __syncthreads();

    // conv1: warp w takes channels 8 NW w .. of every m16 row tile; row k's A
    // row is x[c0][4 q0 - 3 + 2k + tap] at u = 5 + 2k + tap (rows past KROWS
    // repeat the last and are not stored). k8 step s holds c0 = 2s (columns
    // t) and 2s + 1 (columns t + 4).
    for (int mt = 0; mt < MT1; ++mt) {
      const int ka = 16 * mt + g, kb = ka + 8;
      const int ua = 5 + 2 * min(ka, KROWS - 1) + t, ub = 5 + 2 * min(kb, KROWS - 1) + t;
      float c[NW][4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t ah[4], al[4];
        split(__float_as_uint(xs[2 * s * XW + ua]), ah[0], al[0]);
        split(__float_as_uint(xs[2 * s * XW + ub]), ah[1], al[1]);
        split(__float_as_uint(xs[(2 * s + 1) * XW + ua]), ah[2], al[2]);
        split(__float_as_uint(xs[(2 * s + 1) * XW + ub]), ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < NW; ++ni)
          mma_3xtf32(c[ni], ah, al, wh[ni][s][0], wh[ni][s][1], wl[ni][s][0], wl[ni][s][1]);
      }
      // rows ka and kb have g's parity: both go to hO (even k) or hE (odd k)
      float* hs = (g & 1) ? hse : hso;
#pragma unroll
      for (int ni = 0; ni < NW; ++ni) {
        const int ch = 8 * (NW * warp + ni) + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = r ? kb : ka, j = 2 * q0 - 1 + k;
          if (k < KROWS) {
            const bool inside = j >= 0 && j < w1_len;
            *reinterpret_cast<float2*>(hs + (k >> 1) * H_LD + ch) =
                make_float2(inside ? fmaxf(c[ni][2 * r] + b1s[ch], 0.f) : 0.f,
                            inside ? fmaxf(c[ni][2 * r + 1] + b1s[ch + 1], 0.f) : 0.f);
          }
        }
      }
    }
    __syncthreads();

    if (hidden != nullptr) {  // K1b, the group's channels: h1[2 (q0 + i)] = hE[i],
                              // h1[2 (q0 + i) + 1] = hO[i + 1]
      const bool pairs = w1_len % 2 == 0;  // channel rows 8-byte aligned
      for (int blk = warp; blk < (TILE / 8) * (GC1 / 4); blk += THREADS / 32) {
        const int i = 8 * (blk / (GC1 / 4)) + (lane & 7);
        const int c = GC1 * group + 4 * (blk % (GC1 / 4)) + (lane >> 3);
        if (i < n_valid) {
          const float e = hse[i * H_LD + c], d = hso[(i + 1) * H_LD + c];
          float* dst = hidden + ((size_t)b * C1 + c) * w1_len + 2 * (q0 + i);
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(e, d);
          } else {
            dst[0] = e;
            dst[1] = d;
          }
        }
      }
      // where T/2 is odd, the row's last tile also writes h1[T/2 - 1] = hE[n_valid]
      if (w1_len % 2 == 1 && q0 + TILE >= w2_len && tid < GC1) {
        const int c = GC1 * group + tid;
        hidden[((size_t)b * C1 + c) * w1_len + w1_len - 1] = hse[n_valid * H_LD + c];
      }
    }

    // conv2: warp (tap, wn) takes the group's CG channels x positions 32
    // wn .. over the depth's C1 rows of the tap: 0 hO[i], 1 hE[i], 2 hO[i +
    // 1], 3 hE[i + 1]
    const int tap = warp >> 1, wn = warp & 1;
    float acc[4][4][4] = {};
    {
      const float* hs = (tap & 1) ? hse : hso;
#pragma unroll 2
      for (int kc = 0; kc < C1; kc += 8) {
        // A: W2' rows 16 mi + (g, g + 8), columns tap C1 + kc + (t, t + 4), as
        // 8x4 fp32 tiles read as 8x8 b16 ones; B likewise from hE / hO's rows
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t r[4];
          ldsm_x4(r, w2s + (16 * mi + (lane & 15)) * W2_LD + tap * C1 + kc + (lane >> 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(r[e], ah[mi][e], al[mi][e]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4], bh[4], bl[4];
          ldsm_x4(r, hs + (32 * wn + 16 * np + (lane >> 4) * 8 + (lane & 7) + (tap >> 1)) *
                              H_LD + kc + ((lane >> 3) & 1) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(r[e], bh[e], bl[e]);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_3xtf32(acc[mi][2 * np], ah[mi], al[mi], bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(acc[mi][2 * np + 1], ah[mi], al[mi], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with hE and hO, which the sums overwrite
    {
      float* pt = ps + tap * CG * P_LD;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(pt + (16 * mi + g + 8 * r) * P_LD + 32 * wn + 8 * ni +
                                       2 * t) = make_float2(acc[mi][ni][2 * r],
                                                            acc[mi][ni][2 * r + 1]);
    }
    __syncthreads();

    // out[b][c2_0 + c][q0 + i] = relu(((P0 + P1) + P2) + P3 + b2), four
    // positions a thread (4-byte stores where T/4 % 4 != 0, which leaves the
    // channel rows unaligned)
    {
      float* ob = out + ((size_t)b * C2 + c2_0) * w2_len + q0;
      const bool vec = w2_len % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
      for (int u = tid; u < CG * (TILE / 4); u += THREADS) {
        const int c = u / (TILE / 4), i = 4 * (u % (TILE / 4));
        if (i >= n_valid) continue;
        float4 s = *reinterpret_cast<const float4*>(ps + c * P_LD + i);
#pragma unroll
        for (int tp = 1; tp < 4; ++tp) {
          const float4 p = *reinterpret_cast<const float4*>(ps + (tp * CG + c) * P_LD + i);
          s.x += p.x;
          s.y += p.y;
          s.z += p.z;
          s.w += p.w;
        }
        const float bias = b2s[c];
        const float v[4] = {fmaxf(s.x + bias, 0.f), fmaxf(s.y + bias, 0.f),
                            fmaxf(s.z + bias, 0.f), fmaxf(s.w + bias, 0.f)};
        float* dst = ob + (size_t)c * w2_len + i;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          for (int e = 0; e < 4 && i + e < n_valid; ++e) dst[e] = v[e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace tf32_groups

// One persistent block an SM (at most one a tile); with `groups`, as many
// blocks a group of W2''s rows, each group's blocks at most one a tile.
template <typename T>
int launch(void (*kernel)(const T*, const T*, const float*, const T*, const float*, T*, T*, int,
                          int),
           int smem, int threads, int tile, const T* x, const T* w1t, const float* b1,
           const T* w2t, const float* b2, T* out, T* hidden, int batch, int t_len,
           void* stream, int groups = 1) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((t_len / 4 + tile - 1) / tile);
  const int per_group = sms / groups;
  const int grid = (int)(tiles < per_group ? tiles : per_group) * groups;
  if (grid == 0) return 0;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(x, w1t, b1, w2t, b2, out, hidden, batch,
                                                       t_len);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 at the sweep's widths 4 -> c1 -> c2, all on the tensor cores (3xTF32):
// the default (64, 128) and (32, 64) with W2' whole in a block, (128, 256) in
// groups of 64 output channels; hidden may be null (K1); otherwise it
// receives h1 (K1b).
extern "C" int conv_stem_fwd(const float* x, const float* w1t, const float* b1,
                             const float* w2t, const float* b2, float* out,
                             float* hidden, int batch, int t_len, int c1, int c2, void* stream) {
  if (c1 == C1 && c2 == C2)
    return launch<float>(tf32_mma::conv_stem_3xtf32_kernel<C1, C2>,
                         tf32_mma::Layout<C1, C2>::SMEM_BYTES, THREADS, tf32_mma::TILE, x, w1t,
                         b1, w2t, b2, out, hidden, batch, t_len, stream);
  if (c1 == 32 && c2 == 64)
    return launch<float>(tf32_mma::conv_stem_3xtf32_kernel<32, 64>,
                         tf32_mma::Layout<32, 64>::SMEM_BYTES, THREADS, tf32_mma::TILE, x,
                         w1t, b1, w2t, b2, out, hidden, batch, t_len, stream);
  if (c1 == 128 && c2 == 256)
    return launch<float>(tf32_groups::conv_stem_3xtf32_groups_kernel<128, 256>,
                         tf32_groups::Layout<128, 256>::SMEM_BYTES, THREADS, tf32_groups::TILE,
                         x, w1t, b1, w2t, b2, out, hidden, batch, t_len, stream,
                         tf32_groups::Layout<128, 256>::GROUPS);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a block of conv_stem_fwd at (c1, c2), or -1
// where it is not compiled for them.
extern "C" int conv_stem_smem_bytes(int c1, int c2) {
  if (c1 == C1 && c2 == C2) return tf32_mma::Layout<C1, C2>::SMEM_BYTES;
  if (c1 == 32 && c2 == 64) return tf32_mma::Layout<32, 64>::SMEM_BYTES;
  if (c1 == 128 && c2 == 256) return tf32_groups::Layout<128, 256>::SMEM_BYTES;
  return -1;
}

// bf16 x, w1t, w2t and out, fp32 biases: hidden may be null (K1 in bf16);
// otherwise it receives the bf16 h1 that conv2 read (K1b in bf16).
extern "C" int conv_stem_bf16_fwd(const __nv_bfloat16* x, const __nv_bfloat16* w1t,
                                  const float* b1, const __nv_bfloat16* w2t, const float* b2,
                                  __nv_bfloat16* out, __nv_bfloat16* hidden, int batch,
                                  int t_len, void* stream) {
  return launch<__nv_bfloat16>(bf16_mma::conv_stem_bf16_kernel, bf16_mma::SMEM_BYTES, THREADS,
                               bf16_mma::TILE, x, w1t, b1, w2t, b2, out,
                               hidden, batch, t_len, stream);
}
