// Probes of the bf16 fused MLM argmax as first written (a cp.async ring
// that all 256 threads fill, one __syncthreads a 64-deep chunk, one wgmma
// group in flight, both warpgroups folding each finished vocab tile at
// once), kept to measure what bound that design and to time it beside its
// successor in mlm_argmax.cu in one run. Not a kernel of any path: only
// chip_smoke.py calls it. Variants (PROBE):
//   0  the kernel as first written (both WITH_CONF variants);
//   1  (a) the fold removed: a tile's accumulators feed one running max, so
//      the products stay and the bias, compares and exponentials go;
//   2  (b) every block reads vocab tile 0's rows of E for every tile, so E
//      stays in L2 and only h comes from device memory;
//   3  (c) no __syncthreads in the mainloop: stages are refilled while
//      they may still be read. For timing only; its ids are wrong.
// Variants 1-3 give no usable ids.
#include "mlm_argmax.cuh"

namespace {

using namespace mlm;

constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int BK16 = 64;                            // bf16 reduction depth of one stage
constexpr int CHUNKS16 = K / BK16;                  // stages per vocab tile: 12
constexpr int HALF16 = (BM + BN) * 32;              // bf16 values of one 32-deep half
constexpr int STAGE16 = 2 * HALF16;                 // of one stage: 48 KB
constexpr int SMEM16_BYTES = STAGES * STAGE16 * 2;  // 196,608
constexpr int A16_UNITS = BM * BK16 / 8 / THREADS;  // 16 B a thread: 4
constexpr int B16_UNITS = BN * BK16 / 8 / THREADS;  // 8

// Where 16-byte unit c (0..7, 8 bf16 each along k) of row `row` of a stage's
// operand sits: its half, then the 64-byte swizzle of the unit within it.
__device__ __forceinline__ int unit16(int row, int c) {
  return (c >> 2) * HALF16 + row * 32 + (((c & 3) ^ ((row >> 1) & 3)) * 8);
}

template <bool WITH_CONF, int PROBE>
__global__ void __launch_bounds__(THREADS, 1)
mlm_argmax_bf16_probe_kernel(const __nv_bfloat16* __restrict__ h,
                             const __nv_bfloat16* __restrict__ emb,
                             const float* __restrict__ bias, int* __restrict__ ids,
                             float* __restrict__ conf, long long m_rows, int vocab) {
  extern __shared__ __align__(1024) __nv_bfloat16 ring16[];  // [STAGES][2 halves][BM + BN][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int wg = warp >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int steps = (vocab + BN - 1) / BN * CHUNKS16;

  auto load = [&](int step) {
    if (step < steps) {
      __nv_bfloat16* stage = ring16 + (step % STAGES) * STAGE16;
      const int n0 = PROBE == 2 ? 0 : (step / CHUNKS16) * BN, k0 = (step % CHUNKS16) * BK16;
#pragma unroll
      for (int q = 0; q < A16_UNITS; ++q) {
        const int u = tid + THREADS * q, row = u >> 3, c = u & 7;
        const bool ok = m0 + row < m_rows;
        cp_async16(stage + unit16(row, c), ok ? h + (m0 + row) * K + k0 + 8 * c : h, ok);
      }
#pragma unroll
      for (int q = 0; q < B16_UNITS; ++q) {
        const int u = tid + THREADS * q, row = u >> 3, c = u & 7;
        const bool ok = n0 + row < vocab;
        cp_async16(stage + unit16(BM + row, c),
                   ok ? emb + (long long)(n0 + row) * K + k0 + 8 * c : emb, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  Best best[2] = {{-CUDART_INF_F, 0.f, NO_INDEX}, {-CUDART_INF_F, 0.f, NO_INDEX}};

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) load(s);

#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (PROBE != 3) __syncthreads();
    load(step + STAGES - 2);
    const __nv_bfloat16* stage = ring16 + (step % STAGES) * STAGE16;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      const __nv_bfloat16* half = stage + (kk >> 1) * HALF16 + 16 * (kk & 1);
      wgmma_bf16(d, desc(half + wg * 64 * 32), desc(half + BM * 32),
                 (step % CHUNKS16) + kk != 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);

    if (step % CHUNKS16 == CHUNKS16 - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (PROBE == 1) {  // one live value, so that no product is dead
        float m = d[0];
#pragma unroll
        for (int i = 1; i < 128; ++i) m = fmaxf(m, d[i]);
        if (m > best[0].m) {
          best[0].m = m;
          best[0].idx = step;
        }
      } else {
        fold_tile<WITH_CONF>(d, best, (step / CHUNKS16) * BN + 2 * t, bias, vocab);
      }
    }
  }

  store_best<WITH_CONF>(best, m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), m_rows, t, ids,
                        conf);
}

template <bool WITH_CONF, int PROBE>
int launch(const __nv_bfloat16* h, const __nv_bfloat16* emb, const float* bias, int* ids,
           float* conf, long long m_rows, int vocab, void* stream) {
  auto kernel = mlm_argmax_bf16_probe_kernel<WITH_CONF, PROBE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (m_rows == 0) return 0;
  const long long blocks = (m_rows + BM - 1) / BM;
  kernel<<<(unsigned)blocks, THREADS, SMEM16_BYTES, (cudaStream_t)stream>>>(
      h, emb, bias, ids, conf, m_rows, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

// probe 0..3 as above; conf may be null unless with_conf (probe 0 only).
extern "C" int mlm_argmax_bf16_probe(int probe, int with_conf, const __nv_bfloat16* h,
                                     const __nv_bfloat16* emb, const float* bias, int* ids,
                                     float* conf, long long m_rows, int vocab, void* stream) {
  if (with_conf) {
    if (probe != 0) return (int)cudaErrorInvalidValue;
    return launch<true, 0>(h, emb, bias, ids, conf, m_rows, vocab, stream);
  }
  switch (probe) {
    case 0: return launch<false, 0>(h, emb, bias, ids, conf, m_rows, vocab, stream);
    case 1: return launch<false, 1>(h, emb, bias, ids, conf, m_rows, vocab, stream);
    case 2: return launch<false, 2>(h, emb, bias, ids, conf, m_rows, vocab, stream);
    case 3: return launch<false, 3>(h, emb, bias, ids, conf, m_rows, vocab, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
