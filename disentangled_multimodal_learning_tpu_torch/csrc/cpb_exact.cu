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
// the layout each attention consumes with no transpose.  Both layouts
// evaluate a point with the same code (mlp_hidden_rows, mlp_out_rows), so
// the "nk" bias is the "kn" bias transposed, bitwise.
//
// What bounds it on the card: f32 arithmetic.  At production shapes
// (BH = 32, K = 144, N = 2500) a call evaluates the MLP at 11.5 M
// positions, ~2.3 k flops each (26 GFLOP counted from the shapes, 0.39 ms
// at 67 TFLOP/s), and writes only 11.5 M f32 values.  With one point per
// thread, each fmaf of the HID x HID product takes a w2 element from
// shared memory: even as float4 broadcasts one load per 4 fmafs, and on
// Hopper the shared-memory pipe issues about a quarter of the fmaf rate,
// so the loads co-limit the kernel near half the f32 peak.
//
// What the design does about that: the MLP weights (1,185 f32 at O = 1)
// sit in shared memory, read as warp broadcasts; each thread evaluates
// kPoints = 4 positions together (mlp_hidden_rows, mlp_out_rows), so that
// each float4 of w2 feeds 16 fmafs, with h2 of its four points (128 f32)
// in registers and h1 formed one entry at a time; no hidden activation
// ever leaves the SM (the plain version writes [.., HID] twice).  Each
// point keeps the fmaf chain of the single-point functions, so K7's bias
// (which uses those) and both layouts here round the same.  One kernel,
// templated on the layout: a block takes a chunk of kThreads * kPoints
// elements e of one bh's plane, [K, N] ("kn", e = k * N + n) or [N, K]
// ("nk", e = n * K + k), with the bh's K kv coordinates in shared memory;
// a thread takes e = e0 + t + s * kThreads, so the fast index of a warp
// (n in "kn", k in "nk") is the one the stores are contiguous along.

#include <cuda_runtime.h>

#include "cpb_exact.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 4;  // positions per thread
constexpr int kPerBlock = kThreads * kPoints;

template <bool kNk>
__global__ void __launch_bounds__(kThreads)
cpb_exact_fwd_kernel(const float* __restrict__ grid_q,
                     const float* __restrict__ grid_kv,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     float* __restrict__ out, int K, int N, int O) {
  extern __shared__ __align__(16) float smem[];
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, b3, O);
  float* s_kv = smem + mlp_floats(O);  // [K, 2] of this bh
  const int bh = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * K; i += kThreads) {
    s_kv[i] = grid_kv[static_cast<size_t>(bh) * 2 * K + i];
  }
  __syncthreads();

  const int plane = N * K;
  const int e0 = blockIdx.x * kPerBlock + threadIdx.x;
  float fx[kPoints];
  float fy[kPoints];
#pragma unroll
  for (int s = 0; s < kPoints; ++s) {
    // past the plane's end: evaluate its last point, store nothing
    const int e = min(e0 + s * kThreads, plane - 1);
    const int a = e / (kNk ? K : N);
    const int n = kNk ? a : e - a * N;
    const int k = kNk ? e - a * K : a;
    fx[s] = signed_log1p(grid_q[2 * n] - s_kv[2 * k]);
    fy[s] = signed_log1p(grid_q[2 * n + 1] - s_kv[2 * k + 1]);
  }
  float h2[kPoints][kHid];
  mlp_hidden_rows<kPoints>(m, fx, fy, h2);
  for (int o = 0; o < O; ++o) {
    float v[kPoints];
    mlp_out_rows<kPoints>(m, h2, o, O, v);
    float* dst = out + static_cast<size_t>(bh * O + o) * plane;
#pragma unroll
    for (int s = 0; s < kPoints; ++s) {
      const int e = e0 + s * kThreads;
      if (e < plane) dst[e] = v[s];
    }
  }
}

template <bool kNk>
int launch(const float* const* a, float* out, int rows, int K, int N, int O,
           cudaStream_t s) {
  const size_t smem = static_cast<size_t>(mlp_floats(O) + 2 * K) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      cpb_exact_fwd_kernel<kNk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N * K + kPerBlock - 1) / kPerBlock, rows / K);
  cpb_exact_fwd_kernel<kNk><<<grid, kThreads, smem, s>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], out, K, N, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid_q [N, 2], grid_kv [rows, 2] with rows = BH * K, w1 [2, 32], b1 [32],
// w2 [32, 32], b2 [32], w3 [32, O], b3 [O], all f32 -> out [BH, O, K, N]
// (nk = 0) or [BH, O, N, K] (nk = 1).  Needs N * K + 512 < 2^31, BH <=
// 65535 and 2 K + 1,152 + 33 O floats of shared memory (K up to ~27 k).
// Returns cudaGetLastError() after the launch (0 = launched).
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
  float* o = static_cast<float*>(out);
  return nk ? launch<true>(args, o, rows, K, N, O, s)
            : launch<false>(args, o, rows, K, N, O, s);
}

// Bytes of dynamic shared memory a K2-fwd block takes at K kv points and O
// output channels (what chip_smoke.py prints beside the ptxas figures).
extern "C" int dmlt_cpb_exact_fwd_smem(int K, int O) {
  return static_cast<int>((mlp_floats(O) + 2 * K) * sizeof(float));
}
