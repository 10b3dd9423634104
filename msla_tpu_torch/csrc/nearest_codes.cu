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
// D = 128 and 256 (the sweep's widths): the codebook streamed through a ring
// of stages that a producer warp fills by TMA and 8 consumer warps split and
// search, with mbarriers between them and the next block tile's x copied
// under the search (vq_stream.cuh's note; nearest_codes_ring_kernel). Bound
// at N = 352,000 (batch 32), K = 512, D = 256: 9.23e10 FLOP, 0.186 ms at the
// TF32 peak (0.559 ms for the three products), and 360.4 MB in: 0.108 ms.
#include "vq_search.cuh"
#include "vq_stream.cuh"

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

// D >= 128: block tiles of 128 rows, the codebook through the
// ring (vq_stream.cuh); the first warp of each slab writes its 32 ids.
template <int D>
__global__ void __launch_bounds__(vq_stream::THREADS, 1)
nearest_codes_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_cb,
                          const float* __restrict__ e2, int* __restrict__ idx, long long n,
                          int k_codes) {
  using namespace vq_stream;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const Smem<D> sm(ring_smem);
  init_barriers(sm);
  __syncthreads();
  if (threadIdx.x < 32 * PRODUCERS) {
    producer_warpgroup(sm, &map_x, &map_cb, n, k_codes);
    return;
  }
  consumer_registers();
  const long long tiles = block_tiles(n, TILE_ROWS);
  const int lane = threadIdx.x & 31, warp = consumer_warp();
  long long j = 0;
  for (long long t = 0; t < tiles; ++t) {
    int arg[MT][2];
    search_tile(sm, e2, k_codes, t, tiles, j, arg);
    const int code = code_of_lane(arg, lane);
    const long long row = (blockIdx.x + t * gridDim.x) * TILE_ROWS + 32 * (warp % SLABS) + lane;
    if (warp < SLABS && row < n) idx[row] = code;
  }
}

// Allow a kernel `smem` bytes of dynamic shared memory and size its grid: one
// persistent block an SM, at most one a tile of `rows` rows. Returns a CUDA
// error code.
template <typename Kernel>
int grid_of(Kernel kernel, size_t smem, int rows, long long n, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  const long long blocks = (n + rows - 1) / rows;
  *grid = (int)(blocks < sms ? blocks : sms);
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, int rows, const float* x, const float* cb,
           const float* e2, int* idx, long long n, int k_codes, cudaStream_t stream) {
  int grid = 0;
  if (int e = grid_of(kernel, smem, rows, n, &grid)) return e;
  if (grid == 0) return 0;
  kernel<<<grid, threads, smem, stream>>>(x, cb, e2, idx, n, k_codes);
  return (int)cudaGetLastError();
}

template <int D>
int launch_ring(const float* x, const float* cb, const float* e2, int* idx, long long n,
                int k_codes, cudaStream_t stream) {
  const size_t smem = vq_stream::smem_bytes<D>(k_codes, false);
  int grid = 0;
  if (int e = grid_of(nearest_codes_ring_kernel<D>, smem, vq_stream::TILE_ROWS, n, &grid))
    return e;
  if (grid == 0) return 0;
  CUtensorMap map_x, map_cb;  // x's and the codebook's pointers change from call to call
  if (int e = vq_stream::maps<D>(x, cb, n, k_codes, &map_x, &map_cb)) return e;
  nearest_codes_ring_kernel<D><<<grid, vq_stream::THREADS, smem, stream>>>(map_x, map_cb, e2, idx,
                                                                          n, k_codes);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) and the codebook (K, d), both 16-byte aligned, d 64 (the codebook
// held in shared memory), 128 or 256 (the codebook streamed); k_codes must be
// even; the wrapper checks it and that the search's shared memory at (K, d)
// fits (vq_search_smem_bytes, ops/nearest_codes.py search_smem_bytes).
extern "C" int nearest_codes_fwd(const float* x, const float* cb, const float* e2,
                                 int* idx, long long n, int k_codes, int d, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch(nearest_codes_kernel<64>, smem_bytes<64>(k_codes, false), THREADS,
                    WARPS * ROWS, x, cb, e2, idx, n, k_codes, s);
    case 128:
      return launch_ring<128>(x, cb, e2, idx, n, k_codes, s);
    case 256:
      return launch_ring<256>(x, cb, e2, idx, n, k_codes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared memory of a block of the search at K codes of width d, dynamic and
// static: K3's (with_hist 0) or #4's forward (with_hist 1: its histogram and
// an fp64 partial for each of its 8 searching warps); -1 at a width no kernel
// takes. ops/nearest_codes.py search_smem_bytes restates it.
extern "C" int vq_search_smem_bytes(int k_codes, int d, int with_hist) {
  const bool hist = with_hist != 0;
  const size_t partials = hist ? 8 * 8 : 0;
  switch (d) {
    case 64:
      return (int)(smem_bytes<64>(k_codes, hist) + partials);
    case 128:
      return (int)(vq_stream::smem_bytes<128>(k_codes, hist) + partials);
    case 256:
      return (int)(vq_stream::smem_bytes<256>(k_codes, hist) + partials);
    default:
      return -1;
  }
}
