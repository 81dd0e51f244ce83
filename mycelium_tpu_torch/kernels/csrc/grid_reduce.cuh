// Deterministic grid-wide sums for the persistent cooperative kernels (K5
// chain_cg.cu, K6 tree_cg.cu; K8 post_solve.cu takes block_sums for its
// last-block pass): each block writes its partial sum to its own
// slot; after a grid-wide barrier every block adds all slots in the same
// fixed order, so every block holds bit-identical totals and takes the same
// decisions with no further barrier. No float atomics: a rerun on the same
// inputs gives the same result. Terms are exact float64 products of float32
// factors, added in float64 and rounded to float32 once.

#pragma once

#include <cuda_runtime.h>

namespace grid_reduce {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum0(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;   // valid in lane 0
}

__device__ __forceinline__ double prod(float a, float b) {
  return (double)a * (double)b;   // exact
}

// the block's total of v, in a fixed order, returned to every thread;
// sh holds WARPS + 1 doubles of shared memory
__device__ __forceinline__ double block_sum(double v, double* sh) {
  v = warp_sum0(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < WARPS; ++i) s += sh[i];
    sh[WARPS] = s;
  }
  __syncthreads();
  return sh[WARPS];
}

// the block's totals of K values at once, each in the order of block_sum
// (so each equals block_sum of it), returned to every thread in v; sh
// holds K·(WARPS + 1) doubles of shared memory. One pass of barriers for
// all K.
template <int K>
__device__ __forceinline__ void block_sums(double v[K], double* sh) {
  for (int k = 0; k < K; ++k) v[k] = warp_sum0(v[k]);
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < K; ++k) sh[k * WARPS + (threadIdx.x >> 5)] = v[k];
  __syncthreads();
  if (threadIdx.x < K) {
    double s = 0.0;
    for (int i = 0; i < WARPS; ++i) s += sh[threadIdx.x * WARPS + i];
    sh[K * WARPS + threadIdx.x] = s;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) v[k] = sh[K * WARPS + k];
}

__device__ __forceinline__ void put_partial(double v, double* slots,
                                            double* sh) {
  double s = block_sum(v, sh);
  if (threadIdx.x == 0) slots[blockIdx.x] = s;
}

// the sum of every block's slot, in the same order in every block, rounded
// to float32
__device__ __forceinline__ float grid_total(const double* slots, double* sh) {
  double v = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) v += slots[i];
  return (float)block_sum(v, sh);
}

}  // namespace grid_reduce
