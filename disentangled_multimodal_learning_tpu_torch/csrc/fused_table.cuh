// What the fused attentions K6 (fused_table.cu, fused_table_bwd.cu) and K7
// (fused_exact.cu, fused_exact_bwd.cu) share: the limits on K and D and the
// dropout mask; and the CUDA-core block shape and shared-memory row stride
// of K7-fwd and of the chunked attention backward (fused_attention_bwd.cuh;
// K6's tensor-core kernels have their own).
//
// The dropout mask is a counter-based hash of (seed, element index), the
// element index of attn [BH, K, N] being (bh * K + k) * N + n: the forward
// and the backward regenerate the same mask from the seed, with no mask in
// device memory.  ops/fused_table.py dropout_keep_mask computes the same
// bits with int64 tensor ops masked to 32 bits, so the kernels and the
// plain version drop the same elements.  mix32 is the "lowbias32" integer
// finaliser (C. Wellons, hash-prospector); the top 24 bits of the hash are
// compared with round(rate * 2^24).
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;     // queries of one tile
constexpr int kRows = 10;   // kv rows per thread in the [K, kQT] passes
constexpr int kMaxK = 16 * kRows;  // 160: K of a block
constexpr int kMaxD = 64;   // dim_head: 16 threads x 4 columns

// row stride of k, v and the row-major q / g_out tiles in shared memory:
// 16-byte aligned rows (float4 reads), and the two rows a warp reads at
// once fall in different banks
__host__ __device__ constexpr int row_stride(int D) { return D + 4; }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// keep element idx of the attention map?  threshold = round(rate * 2^24);
// threshold 0 keeps every element.  inner0 = mix32(seed_mix), the inner
// hash of a high word 0, computed once by a caller whose indices are
// mostly below 2^32.
__device__ __forceinline__ bool dropout_keep(uint32_t seed_mix,
                                             uint32_t inner0,
                                             unsigned long long idx,
                                             uint32_t threshold) {
  const uint32_t hi = static_cast<uint32_t>(idx >> 32);
  const uint32_t inner = hi == 0u ? inner0 : mix32(hi ^ seed_mix);
  return (mix32(static_cast<uint32_t>(idx) ^ inner) >> 8) >= threshold;
}

__device__ __forceinline__ bool dropout_keep(uint32_t seed_mix,
                                             unsigned long long idx,
                                             uint32_t threshold) {
  return dropout_keep(seed_mix, mix32(seed_mix), idx, threshold);
}

}  // namespace
