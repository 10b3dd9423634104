// Fused VQ-VAE decoder stem: convT k4 s2 p1 (128 -> 64) + ReLU, then
// convT k4 s2 p1 (64 -> 4), in one pass over device memory, on fp32 operands
// or, for the bf16 compute_dtype, bf16 ones (q, w1, w2; the biases stay fp32).
//
// Replaces: msla_tpu/ops/deconv_stem.py:35 _deconv_kernel (deconv_stem_pallas),
// both its forward (K2) and, with a non-null `hidden`, its save_hidden forward
// for training (K2b, the pallas_call at deconv_stem.py:132).
//
// Bound on an H100: at batch 64, W = 11,000 the stem does 4.90e10 fp32 FLOP and
// must move 360.4 MB in + 45.1 MB out (+ 360.4 MB of h for K2b), so it is bound
// by the fp32 FMA rate (67 TFLOP/s outside the tensor cores), not by memory.
// In bf16 the same FLOP held to the bf16 tensor-core peak (989 TFLOP/s) take
// 0.050 ms and the 180.2 MB in + 22.5 MB out 0.061 ms (K2b in bf16 also
// writes 180.2 MB of h: 0.114 ms): bound by bytes. This kernel does not reach
// for that bound: it runs the bf16 function on the fp32
// FMA units, as the Pallas kernel's own arithmetic (exact bf16 products summed
// in fp32), and the bf16 operands only halve its traffic.
//
// Design: a stride-2 transposed conv splits into two unit-stride phases,
//   out[2m]   = x[m] W1 + x[m-1] W3,     out[2m+1] = x[m] W2 + x[m+1] W0,
// so no thread does a zero multiply of the stride-dilated input. The hidden
// h (B, 64, 2W) never reaches device memory: a persistent block (one per SM)
// keeps the first layer's weights (128 KB) in shared memory, computes h for a
// tile plus a one-row halo on each side into shared memory, then the 4-channel
// output from it. In the first layer each thread keeps 4 channels x 5 positions
// of both phases in registers; both phases read the same two input rows, so
// every shared-memory read feeds 8 FMAs. fp32 FMA throughout. K2b copies the
// tile's interior rows of h, [2*m0, 2*m0 + 2*TILE), from shared memory to
// device memory once they are complete: consecutive threads take consecutive
// rows, so the stores are coalesced along W, no row is written by two blocks
// and the halo and pad rows are never written. In bf16 (the Pallas kernel's
// cast points, msla_tpu/ops/deconv_stem.py:35-63) q and the weights are
// widened to fp32 as they enter shared memory, h = relu(sum + b1) is rounded to
// bf16 before the second layer reads it (K2b in bf16 writes that rounded h),
// and the output is rounded to bf16 as it is stored.
//
// Layouts (NCW, as torch): q (B, 128, W), out (B, 4, 4W), hidden (B, 64, 2W).
// Weights in torch's
// ConvTranspose1d layout (in, out, k): w1 (128, 64, 4), w2 (64, 4, 4).
#include <cuda_runtime.h>

#include "operand_type.cuh"

namespace {

using operand_type::from_float;
using operand_type::round_to;
using operand_type::to_float;

constexpr int CI = 128;               // input channels
constexpr int C1 = 64;                // hidden channels
constexpr int CO = 4;                 // output channels
constexpr int TILE = 64;              // input positions per tile
constexpr int NQ = TILE + 2;          // q rows: m0-1 .. m0+TILE
constexpr int NH = 2 * TILE + 2;      // h rows: 2*m0-1 .. 2*m0+2*TILE
constexpr int THREADS = 256;          // == 4 * TILE: one output sample each
constexpr int PT = 5;                 // phase positions per thread (stride 16)
constexpr int CT = 4;                 // hidden channels per thread (stride 16)

constexpr size_t SMEM_FLOATS =
    (size_t)CI * C1 * 4 + (size_t)CI * NQ + (size_t)C1 * NH + C1 * CO * 4 + C1 + CO;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
deconv_stem_kernel(const T* __restrict__ q, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, T* __restrict__ out,
                   T* __restrict__ hidden, int batch, int width) {
  extern __shared__ float smem[];
  float* w1s = smem;                    // [CI][C1][4]
  float* qs = w1s + CI * C1 * 4;        // [CI][NQ]
  float* hs = qs + CI * NQ;             // [C1][NH]
  float* w2s = hs + C1 * NH;            // [C1][CO][4]
  float* b1s = w2s + C1 * CO * 4;       // [C1]
  float* b2s = b1s + C1;                // [CO]

  const int tid = threadIdx.x;
  for (int i = tid; i < CI * C1 * 4; i += THREADS) w1s[i] = to_float(w1[i]);
  for (int i = tid; i < C1 * CO * 4; i += THREADS) w2s[i] = to_float(w2[i]);
  for (int i = tid; i < C1; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < CO; i += THREADS) b2s[i] = b2[i];

  const int tiles_per_row = (width + TILE - 1) / TILE;
  const long long total_tiles = (long long)batch * tiles_per_row;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float4* w1v = reinterpret_cast<const float4*>(w1s);

  for (long long tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int b = (int)(tile / tiles_per_row);
    const int m0 = (int)(tile % tiles_per_row) * TILE;
    __syncthreads();  // previous tile's readers of qs/hs are done

    // qs[ci][u] = q[m0-1+u], zero outside [0, W)
    const T* qb = q + (size_t)b * CI * width;
    for (int i = tid; i < CI * NQ; i += THREADS) {
      const int ci = i / NQ, u = i % NQ, m = m0 - 1 + u;
      qs[i] = (m >= 0 && m < width) ? to_float(qb[(size_t)ci * width + m]) : 0.0f;
    }
    __syncthreads();

    // even phase r: h[2m] with m = m0+r    = qs[r+1] W1 + qs[r] W3
    // odd phase r:  h[2m+1] with m = m0-1+r = qs[r] W2 + qs[r+1] W0
    // for r = 0..TILE; slots beyond TILE compute on a clamped row, stored never
    float he[CT][PT], ho[CT][PT];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int i = 0; i < PT; ++i) he[j][i] = ho[j][i] = 0.0f;
    int rr[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) rr[i] = min(tx + 16 * i, TILE);

    for (int ci = 0; ci < CI; ++ci) {
      float qa[PT], qc[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        qa[i] = qs[ci * NQ + rr[i]];
        qc[i] = qs[ci * NQ + rr[i] + 1];
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float4 w = w1v[ci * C1 + ty + 16 * j];  // taps 0..3
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          he[j][i] = fmaf(qc[i], w.y, he[j][i]);
          he[j][i] = fmaf(qa[i], w.w, he[j][i]);
          ho[j][i] = fmaf(qa[i], w.z, ho[j][i]);
          ho[j][i] = fmaf(qc[i], w.x, ho[j][i]);
        }
      }
    }

    // h rows outside [0, 2W) are the second layer's zero padding; h index
    // 2*m0-1+k sits at hs[c][k]: even phase at k = 2r+1, odd phase at k = 2r
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = ty + 16 * j;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int r = tx + 16 * i;
        if (r <= TILE) {
          const int me = m0 + r, mo = m0 - 1 + r;
          hs[c * NH + 2 * r + 1] =
              me < width ? round_to<T>(fmaxf(he[j][i] + b1s[c], 0.0f)) : 0.0f;
          hs[c * NH + 2 * r] =
              (mo >= 0 && mo < width) ? round_to<T>(fmaxf(ho[j][i] + b1s[c], 0.0f)) : 0.0f;
        }
      }
    }
    __syncthreads();

    if (hidden != nullptr) {
      T* hb = hidden + (size_t)b * C1 * 2 * width;
      for (int i = tid; i < C1 * 2 * TILE; i += THREADS) {
        const int c = i / (2 * TILE), k = 1 + i % (2 * TILE), j = 2 * m0 - 1 + k;
        if (j < 2 * width) hb[(size_t)c * 2 * width + j] = from_float<T>(hs[c * NH + k]);
      }
    }

    // out[4*m0 + tid] = out[2j'+ph], j' = 2*m0+s, h[j'] at hs[s+1]:
    //   ph 0: h[j'] V1 + h[j'-1] V3;  ph 1: h[j'] V2 + h[j'+1] V0  (no ReLU)
    const int s = tid >> 1, ph = tid & 1;
    const int k = s + 1, kb = ph ? k + 1 : k - 1;
    const int ta = ph ? 2 : 1, tb = ph ? 0 : 3;
    float acc[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = b2s[o];
    for (int c = 0; c < C1; ++c) {
      const float ha = hs[c * NH + k], hb = hs[c * NH + kb];
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        acc[o] = fmaf(ha, w2s[(c * CO + o) * 4 + ta], acc[o]);
        acc[o] = fmaf(hb, w2s[(c * CO + o) * 4 + tb], acc[o]);
      }
    }
    const int jo = 4 * m0 + tid;
    if (jo < 4 * width) {
      T* ob = out + (size_t)b * CO * 4 * width;
#pragma unroll
      for (int o = 0; o < CO; ++o) ob[(size_t)o * 4 * width + jo] = from_float<T>(acc[o]);
    }
  }
}

template <typename T>
int launch(const T* q, const T* w1, const float* b1, const T* w2, const float* b2, T* out,
           T* hidden, int batch, int width, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      deconv_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long tiles = (long long)batch * ((width + TILE - 1) / TILE);
  const int grid = (int)(tiles < sms ? tiles : sms);
  if (grid == 0) return 0;
  deconv_stem_kernel<T><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q, w1, b1, w2, b2, out, hidden, batch, width);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32: hidden may be null (K2); otherwise it receives h (K2b).
extern "C" int deconv_stem_fwd(const float* q, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* out,
                               float* hidden, int batch, int width, void* stream) {
  return launch<float>(q, w1, b1, w2, b2, out, hidden, batch, width, stream);
}

// bf16 q, w1, w2 and out, fp32 biases: hidden may be null (K2 in bf16);
// otherwise it receives the bf16 h that the second layer read (K2b in bf16).
extern "C" int deconv_stem_bf16_fwd(const __nv_bfloat16* q, const __nv_bfloat16* w1,
                                    const float* b1, const __nv_bfloat16* w2, const float* b2,
                                    __nv_bfloat16* out, __nv_bfloat16* hidden, int batch,
                                    int width, void* stream) {
  return launch<__nv_bfloat16>(q, w1, b1, w2, b2, out, hidden, batch, width, stream);
}
