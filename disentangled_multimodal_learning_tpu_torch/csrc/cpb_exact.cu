// K2-fwd: exact continuous-position-bias (CPB) MLP, in the kv-major "kn"
// layout and in the query-major "nk" layout.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _cpbt_fwd_kernel (the TPU kernel behind cpb_bias_transposed, "kn") and,
// in "nk", the four TPU kernels that write the same function as [BH, N, K]:
// v1 _cpb_wide_fwd_kernel (cpb_bias_from_grids), v5 _cpb5_fwd_kernel
// (cpb_bias_grids_fused), v2 _cpb_flat_fwd_kernel (cpb_bias) and wide4
// _w4_fwd_kernel (cpb_bias_from_grids_w4).  Those four differ only in the
// TPU layouts of their inputs; at their grid entries all of them map
// grid_q [N, 2] and grid_kv [BH, K, 2] to the bias.
//
// What it computes: for every kv row r = bh * K + k and query n, the MLP of
// cpb_exact.cuh at p = grid_q[n] - grid_kv[r], written to
//     "kn": bias[bh, o, k, n]  ([BH, K, N] when O == 1)
//     "nk": bias[bh, o, n, k]  ([BH, N, K] when O == 1)
// the layout each attention consumes with no transpose.  Both kernels
// evaluate a point with the same code (mlp_hidden, mlp_out), so the "nk"
// bias is the "kn" bias transposed, bitwise.
//
// What bounds it on the card: f32 arithmetic.  At production shapes
// (BH = 32, K = 144, N = 2500) a call evaluates the MLP at 11.5 M
// positions, ~2.3 k flops each (26 GFLOP counted from the shapes), and
// writes only 11.5 M f32 values.
//
// What the design does about that: the MLP weights (1,217 f32 at O = 1) sit
// in shared memory, read as warp broadcasts; each thread evaluates whole
// positions with h1 and h2 (HID = 32 each) in registers, so no hidden
// activation ever leaves the SM (the plain version writes [.., HID] twice).
// "kn": one block per kv row loads the row's coordinate once and writes n
// contiguously.  "nk": one block per (bh, chunk of the [N, K] plane) keeps
// the bh's K kv coordinates in shared memory; a thread takes plane elements
// e = n * K + k, so that k is the fast index within a warp and the stores
// are contiguous (a flag on the row-per-block kernel would write with
// stride K).

#include <cuda_runtime.h>

#include "cpb_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNkPerThread = 4;  // "nk": plane elements per thread

__global__ void __launch_bounds__(kThreads)
cpb_exact_fwd_kernel(const float* __restrict__ grid_q,
                     const float* __restrict__ grid_kv,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     float* __restrict__ out, int K, int N, int O) {
  extern __shared__ __align__(16) float smem[];
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, b3, O);
  __syncthreads();

  const int r = blockIdx.x;
  const int bh = r / K;
  const int k = r - bh * K;
  const float kx = grid_kv[2 * r];
  const float ky = grid_kv[2 * r + 1];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float fx = signed_log1p(grid_q[2 * n] - kx);
    const float fy = signed_log1p(grid_q[2 * n + 1] - ky);
    float h1[kHid];
    float h2[kHid];
    mlp_hidden(m, fx, fy, h1, h2);
    for (int o = 0; o < O; ++o) {
      out[(static_cast<size_t>(bh * O + o) * K + k) * N + n] = mlp_out(m, h2, o, O);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cpb_exact_nk_fwd_kernel(const float* __restrict__ grid_q,
                        const float* __restrict__ grid_kv,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3, float* __restrict__ out,
                        int K, int N, int O) {
  extern __shared__ __align__(16) float smem[];
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, b3, O);
  float* s_kv = smem + mlp_floats(O);  // [K, 2] of this bh
  const int bh = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * K; i += blockDim.x) {
    s_kv[i] = grid_kv[static_cast<size_t>(bh) * 2 * K + i];
  }
  __syncthreads();

  const int plane = N * K;
  const int e0 = blockIdx.x * (kThreads * kNkPerThread);
  const int e1 = min(plane, e0 + kThreads * kNkPerThread);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int n = e / K;
    const int k = e - n * K;
    const float fx = signed_log1p(grid_q[2 * n] - s_kv[2 * k]);
    const float fy = signed_log1p(grid_q[2 * n + 1] - s_kv[2 * k + 1]);
    float h1[kHid];
    float h2[kHid];
    mlp_hidden(m, fx, fy, h1, h2);
    for (int o = 0; o < O; ++o) {
      out[static_cast<size_t>(bh * O + o) * plane + e] = mlp_out(m, h2, o, O);
    }
  }
}

}  // namespace

// grid_q [N, 2], grid_kv [rows, 2] with rows = BH * K, w1 [2, 32], b1 [32],
// w2 [32, 32], b2 [32], w3 [32, O], b3 [O], all f32 -> out [BH, O, K, N]
// (nk = 0) or [BH, O, N, K] (nk = 1).  Needs N * K < 2^31.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dmlt_cpb_exact_fwd(const void* grid_q, const void* grid_kv,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* b3, void* out,
                                  int rows, int K, int N, int O, int nk,
                                  void* stream) {
  if (rows == 0 || N == 0) return 0;
  if (O < 1 || O > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[] = {
      static_cast<const float*>(grid_q), static_cast<const float*>(grid_kv),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3)};
  if (!nk) {
    const size_t smem = static_cast<size_t>(mlp_floats(O)) * sizeof(float);
    cpb_exact_fwd_kernel<<<rows, kThreads, smem, s>>>(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7],
        static_cast<float*>(out), K, N, O);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(mlp_floats(O) + 2 * K) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kNkPerThread;
  const dim3 grid((N * K + per_block - 1) / per_block, rows / K);
  cpb_exact_nk_fwd_kernel<<<grid, kThreads, smem, s>>>(
      args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7],
      static_cast<float*>(out), K, N, O);
  return static_cast<int>(cudaGetLastError());
}
