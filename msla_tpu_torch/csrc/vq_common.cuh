// Pieces shared by the VQ forwards (vq_fused.cu, vq_lean.cu, vq_precision.cu):
// the per-block code histogram, the deterministic per-block sum of the
// squared error, the one-block kernel that turns per-block partials into
// outputs, and the host side of a persistent forward launch.
//
// Counts are integers (exact in any order); the squared-error sum is fp64 per
// thread, reduced per block in a fixed order into one partial per block, and
// the partials are summed in block order: the same bits run after run.
#pragma once

#include <cuda_runtime.h>

namespace vq_common {

constexpr unsigned FULL = 0xffffffffu;

// Count `code` in the block's shared-memory histogram: one atomic per group of
// lanes that picked the same code. Every lane of the warp calls it.
__device__ __forceinline__ void count(int* hist, int code, bool valid, int lane) {
  const unsigned active = __ballot_sync(FULL, valid);
  if (valid) {
    const unsigned peers = __match_any_sync(active, code);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[code], __popc(peers));
  }
}

// End of a forward block: its threads' fp64 sums into sq_part[blockIdx.x] in a
// fixed order, and its histogram into the global integer counts. Every thread
// of the block calls it once.
template <int THREADS>
__device__ __forceinline__ void flush_block(double acc, const int* hist, int* counts_i,
                                            double* sq_part, int k_codes) {
  __shared__ double warp_sq[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
  if (lane == 0) warp_sq[warp] = acc;
  __syncthreads();  // also: every warp's histogram adds are done
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sq[w];
    sq_part[blockIdx.x] = s;
  }
  for (int k = tid; k < k_codes; k += THREADS)
    if (hist[k]) atomicAdd(&counts_i[k], hist[k]);
}

__global__ void finish_kernel(const int* __restrict__ counts_i,
                              const double* __restrict__ sq_part, int parts,
                              float* __restrict__ counts, float* __restrict__ sq, int k_codes) {
  for (int k = threadIdx.x; k < k_codes; k += blockDim.x) counts[k] = (float)counts_i[k];
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int p = 0; p < parts; ++p) s += sq_part[p];
    *sq = (float)s;
  }
}

inline int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Before a persistent forward: allow its dynamic shared memory, zero the
// integer counts, and size its grid (one block per SM at most, at most
// max_parts, none for n = 0). Returns a CUDA error code.
template <typename Kernel>
inline int fwd_begin(Kernel kernel, size_t smem, int* counts_i, int k_codes, long long blocks,
                     int max_parts, cudaStream_t s, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  if ((err = cudaMemsetAsync(counts_i, 0, (size_t)k_codes * sizeof(int), s)) != cudaSuccess)
    return (int)err;
  long long g = blocks < sms ? blocks : sms;
  *grid = (int)(g < max_parts ? g : max_parts);
  return 0;
}

// After it: check its launch (if any) and turn the partials into counts and sq.
inline int fwd_end(int grid, const int* counts_i, const double* sq_part, float* counts,
                   float* sq, int k_codes, cudaStream_t s) {
  if (grid > 0) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<1, 512, 0, s>>>(counts_i, sq_part, grid, counts, sq, k_codes);
  return (int)cudaGetLastError();
}

}  // namespace vq_common
