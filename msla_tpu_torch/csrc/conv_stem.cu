// Fused VQ-VAE encoder stem: conv k4 s2 p1 (4 -> 64) + ReLU, then
// conv k4 s2 p1 (64 -> 128) + ReLU, in one pass over device memory, on fp32
// operands or, for the bf16 compute_dtype, bf16 ones (x, w1, w2; the biases
// stay fp32).
//
// Replaces: msla_tpu/ops/conv_stem.py:48 _stem_kernel (conv_stem_pallas), both
// its forward (K1) and, with a non-null `hidden`, its save_hidden forward for
// training (K1b, the pallas_call at conv_stem.py:132).
//
// Bound on an H100: at batch 64, T = 44,000 the stem does 4.90e10 fp32 FLOP and
// must move 45.1 MB in + 360.4 MB out (+ 360.4 MB of h1 for K1b), so it is
// bound by the fp32 FMA rate (67 TFLOP/s outside the tensor cores), not by
// memory. In bf16 the same FLOP held to the bf16 tensor-core peak (989
// TFLOP/s) take 0.050 ms and the 22.5 MB in + 180.2 MB out 0.061 ms (K1b in
// bf16 also writes 180.2 MB of h1: 0.114 ms): bound by bytes. This kernel
// does not reach for that bound: it runs the bf16 function
// on the fp32 FMA units, as the Pallas kernel's own arithmetic (exact bf16
// products summed in fp32), and the bf16 operands only halve its traffic.
//
// Design: in K1, conv1's output h1 (B, 64, T/2) never reaches device memory;
// K1b also writes it, for the backward, in the operand type (in bf16 the
// rounded h1 that conv2 read, as the Pallas kernel's hidden). A block
// holds the whole conv2 weight (128 KB) plus a tile of h1 in shared memory and is
// persistent: one block per SM loads the weights once and walks over
// (batch row, tile) pairs. Each thread keeps an 8 channel x 8 position register
// tile of conv2 accumulators, so every shared-memory read feeds 8 FMAs.
// Accumulation is fp32 FMA throughout; no tensor cores (fp32 exactness first).
// In bf16 (the Pallas kernel's cast points, msla_tpu/ops/conv_stem.py:54-75)
// x and the weights are widened to fp32 as they enter shared memory, so every
// product of two bf16 values is exact; h1 = relu(sum + b1) is rounded to bf16
// before conv2 reads it, and the output is rounded to bf16 as it is stored.
// Any T >= 4 (the last tile is ragged): out has floor(T/4) columns and h1
// floor(T/2); when T/2 is odd, h1's last row 2*(T/4) is a real row that
// conv2's last column reads, not padding, and the last tile writes it in K1b.
// K1b stores each h1 row of the tile's interior [2*q0, 2*q0 + 2*TILE) once,
// after the ReLU, as it is computed: consecutive threads hold consecutive rows,
// so the stores are coalesced along W, no row is written by two blocks and the
// halo and pad rows are never written.
//
// Layouts (NCW, as torch): x (B, 4, T), out (B, 128, T/4), hidden (B, 64, T/2).
// Weights arrive
// pre-transposed by the wrapper: w1t (4*4, 64) indexed [c0*4+tap][c1],
// w2t (64*4, 128) indexed [c1*4+tap][c2].
#include <cuda_runtime.h>

#include "operand_type.cuh"

namespace {

using operand_type::from_float;
using operand_type::round_to;
using operand_type::to_float;

constexpr int C0 = 4;
constexpr int C1 = 64;
constexpr int C2 = 128;
constexpr int TILE = 128;             // conv2 output positions per tile
constexpr int NH = 2 * TILE + 2;      // h1 rows a tile needs: 2*q0-1 .. 2*q0+2*TILE
constexpr int NX = 4 * TILE + 6;      // samples a tile needs: 4*q0-3 .. 4*q0+4*TILE+2
constexpr int THREADS = 256;
constexpr int PT = 8;                 // positions per thread (stride 16)
constexpr int CT = 8;                 // channels per thread (stride 16)

constexpr size_t SMEM_FLOATS =
    (size_t)C1 * 4 * C2 + (size_t)C1 * NH + (size_t)C0 * NX + C0 * 4 * C1 + C1 + C2;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_stem_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                 const float* __restrict__ b1, const T* __restrict__ w2t,
                 const float* __restrict__ b2, T* __restrict__ out,
                 T* __restrict__ hidden, int batch, int t_len) {
  extern __shared__ float smem[];
  float* w2s = smem;                    // [C1*4][C2]
  float* h1s = w2s + C1 * 4 * C2;       // [C1][NH]
  float* xs = h1s + C1 * NH;            // [C0][NX]
  float* w1s = xs + C0 * NX;            // [C0*4][C1]
  float* b1s = w1s + C0 * 4 * C1;       // [C1]
  float* b2s = b1s + C1;                // [C2]

  const int tid = threadIdx.x;
  for (int i = tid; i < C1 * 4 * C2; i += THREADS) w2s[i] = to_float(w2t[i]);
  for (int i = tid; i < C0 * 4 * C1; i += THREADS) w1s[i] = to_float(w1t[i]);
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C2; i += THREADS) b2s[i] = b2[i];

  const int w1_len = t_len / 2;       // conv1 output width
  const int w2_len = t_len / 4;       // conv2 output width
  const int tiles_per_row = (w2_len + TILE - 1) / TILE;
  const long long total_tiles = (long long)batch * tiles_per_row;
  const int tx = tid & 15;            // position lane
  const int ty = tid >> 4;            // channel lane

  for (long long tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int b = (int)(tile / tiles_per_row);
    const int q0 = (int)(tile % tiles_per_row) * TILE;
    __syncthreads();  // previous tile's readers of xs/h1s are done

    // waveform window, zero outside [0, T) (conv1's own p=1 padding)
    const T* xb = x + (size_t)b * C0 * t_len;
    const int x0 = 4 * q0 - 3;
    for (int i = tid; i < C0 * NX; i += THREADS) {
      const int c = i / NX, u = i % NX, s = x0 + u;
      xs[i] = (s >= 0 && s < t_len) ? to_float(xb[(size_t)c * t_len + s]) : 0.0f;
    }
    __syncthreads();

    // h1[j] = relu(conv1) for j = 2*q0-1+k; rows outside [0, T/2) are conv2's
    // p=1 zero padding, which applies to relu(conv1), not to the waveform.
    // A tile writes the hidden rows of its interior [2*q0, 2*q0 + 2*TILE); a
    // row's last tile also writes row 2*q0 + 2*TILE if it is a real row
    const int j0 = 2 * q0 - 1;
    const int last_k = q0 + TILE >= w2_len ? 2 * TILE + 1 : 2 * TILE;
    for (int i = tid; i < C1 * NH; i += THREADS) {
      const int c1 = i / NH, k = i % NH, j = j0 + k;
      float acc = b1s[c1];
#pragma unroll
      for (int c0 = 0; c0 < C0; ++c0)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc = fmaf(w1s[(c0 * 4 + t) * C1 + c1], xs[c0 * NX + 2 * k + t], acc);
      const float h = (j >= 0 && j < w1_len) ? round_to<T>(fmaxf(acc, 0.0f)) : 0.0f;
      h1s[i] = h;
      if (hidden != nullptr && k >= 1 && k <= last_k && j < w1_len)
        hidden[((size_t)b * C1 + c1) * w1_len + j] = from_float<T>(h);
    }
    __syncthreads();

    // out2[q0+p] = relu(b2 + sum_{c1,t} w2[c2][c1][t] * h1[2(q0+p)-1+t]),
    // and h1[2(q0+p)-1+t] sits at h1s[c1][2p+t]
    float acc[CT][PT];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[j][i] = 0.0f;

    for (int c1 = 0; c1 < C1; ++c1) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float hv[PT], wv[CT];
#pragma unroll
        for (int i = 0; i < PT; ++i) hv[i] = h1s[c1 * NH + 2 * (tx + 16 * i) + t];
#pragma unroll
        for (int j = 0; j < CT; ++j) wv[j] = w2s[(c1 * 4 + t) * C2 + ty + 16 * j];
#pragma unroll
        for (int j = 0; j < CT; ++j)
#pragma unroll
          for (int i = 0; i < PT; ++i) acc[j][i] = fmaf(wv[j], hv[i], acc[j][i]);
      }
    }

    T* ob = out + (size_t)b * C2 * w2_len;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c2 = ty + 16 * j;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int q = q0 + tx + 16 * i;
        if (q < w2_len)
          ob[(size_t)c2 * w2_len + q] = from_float<T>(fmaxf(acc[j][i] + b2s[c2], 0.0f));
      }
    }
  }
}

template <typename T>
int launch(const T* x, const T* w1t, const float* b1, const T* w2t, const float* b2, T* out,
           T* hidden, int batch, int t_len, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((t_len / 4 + TILE - 1) / TILE);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (grid == 0) return 0;
  conv_stem_kernel<T><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, w1t, b1, w2t, b2, out, hidden, batch, t_len);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32: hidden may be null (K1); otherwise it receives h1 (K1b).
extern "C" int conv_stem_fwd(const float* x, const float* w1t, const float* b1,
                             const float* w2t, const float* b2, float* out,
                             float* hidden, int batch, int t_len, void* stream) {
  return launch<float>(x, w1t, b1, w2t, b2, out, hidden, batch, t_len, stream);
}

// bf16 x, w1t, w2t and out, fp32 biases: hidden may be null (K1 in bf16);
// otherwise it receives the bf16 h1 that conv2 read (K1b in bf16).
extern "C" int conv_stem_bf16_fwd(const __nv_bfloat16* x, const __nv_bfloat16* w1t,
                                  const float* b1, const __nv_bfloat16* w2t, const float* b2,
                                  __nv_bfloat16* out, __nv_bfloat16* hidden, int batch,
                                  int t_len, void* stream) {
  return launch<__nv_bfloat16>(x, w1t, b1, w2t, b2, out, hidden, batch, t_len, stream);
}
