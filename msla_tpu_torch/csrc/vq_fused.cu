// The fused training VQ: its forward (ids, quantized rows, code counts and the
// squared-error sum in one pass) and its codebook gradient (a segment sum).
//
// Replaces: msla_tpu/ops/vq_fused.py:42 _fwd_kernel (vq_fused_fwd_pallas) and
// msla_tpu/ops/vq_fused.py:81 _bwd_kernel (vq_codebook_grad_pallas).
//
// Bounds on an H100, at N = 704,000 rows, K = 512, D = 64:
// - forward: 2*N*K*D = 4.61e10 FLOP for the distances, 0.093 ms at the TF32
//   tensor-core peak (0.279 ms for 3xTF32's three products), and 180.2 MB in
//   (x) + 180.2 MB out (q) + 2.8 MB (ids): 0.108 ms at 3.35 TB/s, so bound by
//   the bytes.
// - codebook gradient: 2.9e7 adds on 180.2 MB of g and 2.8 MB of ids, so it is
//   bound by memory (3.35 TB/s), 0.055 ms. The TPU's one-hot matmul was how
//   the TPU did the sum, not work the function needs.
//
// Forward design: K3's search (vq_search.cuh: 3xTF32 on mma.sync, the argmin
// folded in registers, the first index on ties as the TPU kernel's
// `dist <= m` then min-lane), a warp a 32-row tile. Then, per tile, with each
// lane holding one row's code:
// - q is the chosen codebook row copied from the fp32 codebook in shared
//   memory: exact, as the TPU's one-hot matmul is, with no matmul and never
//   rebuilt from the split parts. 16 lanes x 16 B write a row, so every store
//   is a whole 256 B row;
// - the code is counted in a per-block shared-memory histogram, one int atomic
//   per group of lanes that picked the same code (__match_any_sync); each
//   block adds its histogram to global int counts (integers: exact in any
//   order);
// - (q - x)^2 is summed from the exact fp32 x (the tile in shared memory, not
//   its split parts), per row in fp32 in a fixed order (4 products a lane, then
//   a fixed tree over the row's 16 lanes) and per thread in fp64, reduced per
//   block in a fixed order into a per-block partial, and the partials are
//   summed in block order by a last one-block kernel: deterministic (a warp's
//   tiles follow from the grid, which the card's SM count fixes).
// The x tile holds the exact x until that sum is taken, so the copy of the
// warp's next tile starts after it, not under the search as in K3.
//
// D = 128 and 256 (the sweep's widths): K3's ring (vq_stream.cuh: the
// codebook through 4 TMA stages split once a block tile, mbarriers, the next
// tile's x copied under the search; vq_fused_ring_kernel). The x slices are
// refilled before a tile's search ends, so q (the chosen row) and the exact x
// of the squared error are read from device memory (L2) after it, the rows
// of a slab shared between its warps; the rest as above. Bound at N =
// 352,000 (batch 32), K = 512, D = 256: 9.23e10 FLOP, 0.186 ms at the TF32
// peak (0.559 ms for three products), and 360.4 MB in + 360.4 MB out: 0.216
// ms.
//
// Codebook gradient: segment_sum.cuh (the design shared with #9's split2
// gradient: TMA-fed, sorted per 32-row group, one fixed order, no atomics),
// over D / 64 column slices where D > 64.
#include "segment_sum.cuh"
#include "vq_common.cuh"
#include "vq_search.cuh"
#include "vq_stream.cuh"

namespace {

using vq_common::FULL;

// ---- forward ------------------------------------------------------------------

// The warp's rows row0 .. row0 + 31 (row r's code in lane r) take their codes'
// codebook rows, from the codebook in shared memory (`es`, swizzled); returns
// the lane's share of sum (q - x)^2 over those rows.
template <int DD>
__device__ __forceinline__ double store_rows(float* __restrict__ q, const float* es,
                                             const float* xs, long long row0, long long n,
                                             int code, int lane) {
  static_assert(DD % 64 == 0, "16 lanes take a row's 16-byte chunks");
  using vq_search::chunk;
  float4* q4 = reinterpret_cast<float4*>(q);
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < vq_search::ROWS / 2; ++s) {
    const int r = 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const long long row = row0 + r;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < DD / 64; ++i) {
      const int ch = 16 * i + (lane & 15);
      const float4 e = chunk(es, c, ch, DD);
      const float4 v = chunk(xs, r, ch, DD);
      if (row < n) q4[row * (DD / 4) + ch] = e;
      const float dx = e.x - v.x, dy = e.y - v.y, dz = e.z - v.z, dw = e.w - v.w;
      part = fmaf(dx, dx, part);
      part = fmaf(dy, dy, part);
      part = fmaf(dz, dz, part);
      part = fmaf(dw, dw, part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if ((lane & 15) == 0 && row < n) acc += (double)part;
  }
  return acc;
}

template <int DD>
__global__ void __launch_bounds__(vq_search::THREADS, 1)
vq_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                    const float* __restrict__ e2, float* __restrict__ q,
                    int* __restrict__ idx, int* __restrict__ counts_i,
                    double* __restrict__ sq_part, long long n, int k_codes) {
  using namespace vq_search;
  extern __shared__ float4 fwd_smem4[];
  const int kpad = padded_codes(k_codes);
  float* es = reinterpret_cast<float*>(fwd_smem4);   // [kpad][DD], swizzled
  float* e2s = es + (size_t)kpad * DD;               // [kpad]
  float* tiles_s = e2s + kpad;                       // [WARPS][ROWS][DD], swizzled
  int* hist = reinterpret_cast<int*>(tiles_s + WARPS * ROWS * DD);  // [K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = tiles_s + warp * ROWS * DD;

  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long stride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile < tiles) load_tile<DD>(xs, x, tile * ROWS, n, lane);  // under the codebook's load
  load_codebook<DD>(es, e2s, cb, e2, k_codes);
  for (int i = tid; i < k_codes; i += THREADS) hist[i] = 0;
  __syncthreads();

  double acc = 0.0;
  for (; tile < tiles; tile += stride) {
    wait_tile();
    RowFrags<DD> a;
    a.load(xs, lane);
    int arg[MT][2];
    search(a, xs, es, e2s, kpad, lane, arg);
    const int code = code_of_lane(arg, lane);
    const long long row0 = tile * ROWS;
    const bool valid = row0 + lane < n;
    if (valid) idx[row0 + lane] = code;
    vq_common::count(hist, code, valid, lane);
    acc += store_rows<DD>(q, es, xs, row0, n, code, lane);
    __syncwarp();
    if (tile + stride < tiles) load_tile<DD>(xs, x, (tile + stride) * ROWS, n, lane);
  }

  vq_common::flush_block<THREADS>(acc, hist, counts_i, sq_part, k_codes);
}

// Rows row0 + first .. row0 + first + count - 1 of a slab (row r's code in
// lane r) take their codes' rows of the (K, DD) codebook in device memory;
// returns the lane's share of sum (q - x)^2 over them, x read from device
// memory, in store_rows' order.
template <int DD>
__device__ __forceinline__ double store_rows_global(float* __restrict__ q,
                                                    const float* __restrict__ cb,
                                                    const float* __restrict__ x, long long row0,
                                                    long long n, int code, int lane, int first,
                                                    int count) {
  static_assert(DD % 64 == 0, "16 lanes take a row's 16-byte chunks");
  const float4* cb4 = reinterpret_cast<const float4*>(cb);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* q4 = reinterpret_cast<float4*>(q);
  double acc = 0.0;
#pragma unroll
  for (int s = 0; s < count / 2; ++s) {
    const int r = first + 2 * s + (lane >> 4);
    const int c = __shfl_sync(FULL, code, r);
    const long long row = row0 + r;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < DD / 64; ++i) {
      const int ch = 16 * i + (lane & 15);
      const float4 e = cb4[(size_t)c * (DD / 4) + ch];
      const float4 v = row < n ? x4[row * (DD / 4) + ch] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n) q4[row * (DD / 4) + ch] = e;
      const float dx = e.x - v.x, dy = e.y - v.y, dz = e.z - v.z, dw = e.w - v.w;
      part = fmaf(dx, dx, part);
      part = fmaf(dy, dy, part);
      part = fmaf(dz, dz, part);
      part = fmaf(dw, dw, part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if ((lane & 15) == 0 && row < n) acc += (double)part;
  }
  return acc;
}

// vq_common::flush_block for the ring's consumer warps alone (the producer
// warpgroup has left): their fp64 sums into sq_part[blockIdx.x] in warp
// order, and the histogram into the global integer counts. Every consumer
// thread calls it once.
__device__ __forceinline__ void flush_consumers(double acc, const int* hist, int* counts_i,
                                                double* sq_part, int k_codes) {
  using vq_stream::CONSUMERS;
  using vq_stream::CTHREADS;
  __shared__ double warp_sq[CONSUMERS];
  const int tid = vq_stream::consumer_tid(), lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
  if (lane == 0) warp_sq[warp] = acc;
  // also: every consumer's histogram adds are done (bar 0 is the block's, 1-4 the slabs')
  asm volatile("bar.sync 5, %0;\n" :: "n"(CTHREADS) : "memory");
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < CONSUMERS; ++w) s += warp_sq[w];
    sq_part[blockIdx.x] = s;
  }
  for (int k = tid; k < k_codes; k += CTHREADS)
    if (hist[k]) atomicAdd(&counts_i[k], hist[k]);
}

// D >= 128: block tiles of 128 rows, the codebook through the
// ring (vq_stream.cuh). A slab's first warp writes and counts its 32 ids; its
// two warps take 16 of its rows' q each.
template <int DD>
__global__ void __launch_bounds__(vq_stream::THREADS, 1)
vq_fused_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_cb, const float* __restrict__ x,
                     const float* __restrict__ cb, const float* __restrict__ e2,
                     float* __restrict__ q, int* __restrict__ idx, int* __restrict__ counts_i,
                     double* __restrict__ sq_part, long long n, int k_codes) {
  using namespace vq_stream;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const Smem<DD> sm(ring_smem);
  init_barriers(sm);
  for (int i = threadIdx.x; i < k_codes; i += THREADS) sm.hist[i] = 0;
  __syncthreads();
  if (threadIdx.x < 32 * PRODUCERS) {
    producer_warpgroup(sm, &map_x, &map_cb, n, k_codes);
    return;
  }
  consumer_registers();
  const long long tiles = block_tiles(n, TILE_ROWS);
  const int lane = threadIdx.x & 31, warp = consumer_warp();
  const int rw = warp % SLABS, cw = warp / SLABS;
  double acc = 0.0;
  long long j = 0;
  for (long long t = 0; t < tiles; ++t) {
    int arg[MT][2];
    search_tile(sm, e2, k_codes, t, tiles, j, arg);
    const int code = vq_search::code_of_lane(arg, lane);
    const long long row0 = (blockIdx.x + t * gridDim.x) * TILE_ROWS + 32 * rw;
    if (cw == 0) {
      const bool valid = row0 + lane < n;
      if (valid) idx[row0 + lane] = code;
      vq_common::count(sm.hist, code, valid, lane);
    }
    acc += store_rows_global<DD>(q, cb, x, row0, n, code, lane, 32 / HALVES * cw, 32 / HALVES);
    // every block has a tile (the grid is at most the tiles); flushed from inside the
    // loop, as ptxas then gives the consumers setmaxnreg's registers (after it: 168, spills)
    if (t + 1 == tiles) flush_consumers(acc, sm.hist, counts_i, sq_part, k_codes);
  }
}

template <int DD>
int fused_ring(const float* x, const float* cb, const float* e2, float* q, int* idx,
               float* counts, float* sq, int* counts_i, double* sq_part, int max_parts,
               long long n, int k_codes, cudaStream_t s) {
  using vq_stream::TILE_ROWS;
  const size_t smem = vq_stream::smem_bytes<DD>(k_codes, true);
  int grid = 0;
  if (int e = vq_common::fwd_begin(vq_fused_ring_kernel<DD>, smem, counts_i, k_codes,
                                   (n + TILE_ROWS - 1) / TILE_ROWS, max_parts, s, &grid))
    return e;
  if (grid > 0) {
    CUtensorMap map_x, map_cb;  // x's and the codebook's pointers change from call to call
    if (int e = vq_stream::maps<DD>(x, cb, n, k_codes, &map_x, &map_cb)) return e;
    vq_fused_ring_kernel<DD><<<grid, vq_stream::THREADS, smem, s>>>(
        map_x, map_cb, x, cb, e2, q, idx, counts_i, sq_part, n, k_codes);
  }
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

template <typename Kernel>
int fused_fwd(Kernel kernel, size_t smem, int threads, int rows, const float* x, const float* cb,
              const float* e2, float* q, int* idx, float* counts, float* sq, int* counts_i,
              double* sq_part, int max_parts, long long n, int k_codes, cudaStream_t s) {
  const long long blocks = (n + rows - 1) / rows;
  int grid = 0;
  if (int e = vq_common::fwd_begin(kernel, smem, counts_i, k_codes, blocks, max_parts, s, &grid))
    return e;
  if (grid > 0)
    kernel<<<grid, threads, smem, s>>>(x, cb, e2, q, idx, counts_i, sq_part, n, k_codes);
  return vq_common::fwd_end(grid, counts_i, sq_part, counts, sq, k_codes, s);
}

}  // namespace

// x, the codebook and q are (., d), 16-byte aligned, d 64 (the codebook held
// in shared memory), 128 or 256 (the codebook streamed, q read from it in
// device memory); q (n, d), idx (n,), counts (K,) and sq () are the outputs;
// counts_i (K,) int and sq_part (max_parts,) double are scratch. k_codes must
// be even; the wrapper checks it and that the search's shared memory at
// (K, d) with the histogram fits (ops/nearest_codes.py search_smem_bytes).
extern "C" int vq_fused_fwd(const float* x, const float* cb, const float* e2, float* q,
                            int* idx, float* counts, float* sq, int* counts_i,
                            double* sq_part, int max_parts, long long n, int k_codes, int d,
                            void* stream) {
  using namespace vq_search;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return fused_fwd(vq_fused_fwd_kernel<64>, smem_bytes<64>(k_codes, true), THREADS,
                       WARPS * ROWS, x, cb, e2, q, idx, counts, sq, counts_i, sq_part,
                       max_parts, n, k_codes, s);
    case 128:
      return fused_ring<128>(x, cb, e2, q, idx, counts, sq, counts_i, sq_part, max_parts, n,
                             k_codes, s);
    case 256:
      return fused_ring<256>(x, cb, e2, q, idx, counts, sq, counts_i, sq_part, max_parts, n,
                             k_codes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of the codebook-gradient kernel at K codes that run at once.
extern "C" int vq_codebook_grad_clusters(int k_codes, int* clusters) {
  return segsum::max_clusters<false>(k_codes, clusters);
}

// g (n, d) fp32, d a multiple of 4, and idx (n,) int32, both 16-byte
// aligned; dcb (K, d) is the output: the sums of codes code0 .. code0 + K - 1
// (ids outside them add nothing); partials (ceil(d / 64), clusters, K, 64)
// is scratch: ceil(d / 64) column slices of `clusters` clusters each; part p
// of a slice's clusters * 4 blocks takes the rows [p * rows_per_part, ...),
// a multiple of 64. The wrapper checks that ops/vq_fused.py grad_smem_bytes(K)
// fit (K <= 701) and runs a larger K as runs of codes (plan_grad).
extern "C" int vq_codebook_grad(const float* g, const int* idx, float* dcb, float* partials,
                                int clusters, long long rows_per_part, long long n, int code0,
                                int k_codes, int d, void* stream) {
  return segsum::launch<false>(g, idx, dcb, partials, clusters, rows_per_part, n, k_codes,
                               (cudaStream_t)stream, d, code0);
}
