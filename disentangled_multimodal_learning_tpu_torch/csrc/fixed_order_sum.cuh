// Fixed-order sums shared by the backward kernels (K1-bwd cpb_table_bwd.cu,
// K2-bwd cpb_exact_bwd.cu, K4-bwd cpb_table_1d_bwd.cu).
//
// Blocks run in no order, so f32 atomics would make every training step
// non-reproducible.  Each backward kernel instead sums a row's values over
// its block with block_sum (warp shuffles, then the warps in order), and
// writes one partial result per block, which sum_partials adds up in block
// order.  The order of every addition is then fixed by the launch shape,
// and two runs on the same inputs give bitwise-equal results.
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cuda_runtime.h>

namespace {

// v[i] summed over the block of kThreads threads, valid in thread 0 only.
// red is shared scratch of NV * kThreads / 32 floats; the caller syncs
// before it reuses red.
template <int kThreads, int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
      v[i] = s;
    }
  }
}

// out[i] = sum over the nparts partial arrays of n floats, in part order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int nparts, int n,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int p = 0; p < nparts; ++p) s += partial[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

// Launches sum_partials_kernel on stream; returns cudaGetLastError().
inline int sum_partials(const void* partial, int nparts, int n, void* out,
                        cudaStream_t stream) {
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), nparts, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
