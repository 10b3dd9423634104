// Nearest-codebook lookup: idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k), lowest
// index on ties; |x_n|^2 is constant per row and dropped.
//
// Replaces: msla_tpu/ops/vq_pallas.py:40 _nearest_codes_kernel
// (nearest_codes_pallas).
//
// Bound on an H100: at N = 704,000 rows, K = 512 codes, D = 64 the lookup does
// 2*N*K*D = 4.61e10 FLOP and must move 180.2 MB in + 2.8 MB out: 0.093 ms at
// the TF32 tensor-core peak, 0.279 ms for 3xTF32's three products, 0.055 ms
// for the bytes.
//
// Design: vq_search.cuh's search, 3xTF32 on mma.sync with the argmin folded
// in registers; the (N, K) distance matrix (1.44 GB at that size) never
// exists. A warp splits its 32-row tile's A fragments into registers, starts
// the copy of its next tile into the freed x tile, then searches the codes and
// writes its 32 ids as one 128-byte store.
//
// D = 128 and 256 (the sweep's widths; vq_search.cuh's note): the codebook
// streamed through shared memory in groups of 32 codes, every warp of the
// block on each group (nearest_codes_stream_kernel). Bound at N = 352,000
// (batch 32), K = 512, D = 256: 9.23e10 FLOP, 0.186 ms at the TF32 peak
// (0.559 ms for the three products), and 360.4 MB in: 0.108 ms.
#include "vq_search.cuh"

namespace {

using namespace vq_search;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
nearest_codes_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ e2, int* __restrict__ idx, long long n,
                     int k_codes) {
  extern __shared__ float4 smem4[];
  const int kpad = padded_codes(k_codes);
  float* es = reinterpret_cast<float*>(smem4);  // [kpad][D], swizzled
  float* e2s = es + (size_t)kpad * D;           // [kpad]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xs = e2s + kpad + warp * ROWS * D;     // this warp's [ROWS][D], swizzled

  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile < tiles) load_tile<D>(xs, x, tile * ROWS, n, lane);  // under the codebook's load
  load_codebook<D>(es, e2s, cb, e2, k_codes);
  __syncthreads();

  constexpr bool hold = kHoldA<D>;
  for (; tile < tiles; tile += stride) {
    wait_tile();
    RowFrags<D> a;
    a.load(xs, lane);
    if (hold) {
      __syncwarp();
      if (tile + stride < tiles) load_tile<D>(xs, x, (tile + stride) * ROWS, n, lane);
    }
    int arg[MT][2];
    search(a, xs, es, e2s, kpad, lane, arg);
    if (!hold) {
      __syncwarp();
      if (tile + stride < tiles) load_tile<D>(xs, x, (tile + stride) * ROWS, n, lane);
    }
    const int code = code_of_lane(arg, lane);
    const long long row = tile * ROWS + lane;
    if (row < n) idx[row] = code;
  }
}

// D >= 128: a block tile of kStreamWarps x 32 rows at a time, the codebook
// streamed (search_streamed).
template <int D>
__global__ void __launch_bounds__(32 * kStreamWarps<D>, 1)
nearest_codes_stream_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                            const float* __restrict__ e2, int* __restrict__ idx, long long n,
                            int k_codes) {
  constexpr int W = kStreamWarps<D>, T = 32 * W;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);     // [STAGES][GROUP][D], swizzled
  float* e2s = stages + STAGES * GROUP * D;            // [kpad]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xs = e2s + padded_codes(k_codes) + warp * ROWS * D;  // this warp's [ROWS][D]

  load_norms<T>(e2s, e2, k_codes);
  const long long tiles = (n + W * ROWS - 1) / (W * ROWS);
  for (long long bt = blockIdx.x; bt < tiles; bt += gridDim.x) {
    const long long row0 = (bt * W + warp) * ROWS;
    load_tile<D>(xs, x, row0, n, lane);
    int arg[MT][2];
    search_streamed<D, T>(xs, stages, cb, e2s, k_codes, lane, arg);
    const int code = code_of_lane(arg, lane);
    if (row0 + lane < n) idx[row0 + lane] = code;
  }
}

// One persistent block an SM, at most one a tile of `rows` rows.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, int rows, const float* x, const float* cb,
           const float* e2, int* idx, long long n, int k_codes, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long blocks = (n + rows - 1) / rows;
  const int grid = (int)(blocks < sms ? blocks : sms);
  if (grid == 0) return 0;
  kernel<<<grid, threads, smem, stream>>>(x, cb, e2, idx, n, k_codes);
  return (int)cudaGetLastError();
}

template <int D>
int launch_streamed(const float* x, const float* cb, const float* e2, int* idx, long long n,
                    int k_codes, cudaStream_t stream) {
  return launch(nearest_codes_stream_kernel<D>, stream_smem_bytes<D>(k_codes, false),
                32 * kStreamWarps<D>, kStreamWarps<D> * ROWS, x, cb, e2, idx, n, k_codes,
                stream);
}

}  // namespace

// x (n, d) and the codebook (K, d), d 64 (the codebook held in shared
// memory), 128 or 256 (the codebook streamed); k_codes must be even; the
// wrapper checks it and that the search's shared memory at (K, d) fits
// (ops/nearest_codes.py search_smem_bytes).
extern "C" int nearest_codes_fwd(const float* x, const float* cb, const float* e2,
                                 int* idx, long long n, int k_codes, int d, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch(nearest_codes_kernel<64>, smem_bytes<64>(k_codes, false), THREADS,
                    WARPS * ROWS, x, cb, e2, idx, n, k_codes, s);
    case 128:
      return launch_streamed<128>(x, cb, e2, idx, n, k_codes, s);
    case 256:
      return launch_streamed<256>(x, cb, e2, idx, n, k_codes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
