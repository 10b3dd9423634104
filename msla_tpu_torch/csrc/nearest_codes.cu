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

constexpr int D = 64;

}  // namespace

// k_codes must be even; the wrapper checks it and that smem_bytes<64>(K)
// fit.
extern "C" int nearest_codes_fwd(const float* x, const float* cb, const float* e2,
                                 int* idx, long long n, int k_codes, void* stream) {
  const size_t smem = smem_bytes<D>(k_codes, false);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_codes_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long blocks = ((n + ROWS - 1) / ROWS + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < sms ? blocks : sms);
  if (grid == 0) return 0;
  nearest_codes_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, cb, e2, idx, n, k_codes);
  return (int)cudaGetLastError();
}
