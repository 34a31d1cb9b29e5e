// K6-bwd: gradient of the fused divisor-1 table attention (fused_table.cu).
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _v10_bwd_kernel (the TPU kernel behind the custom VJP of
// fused_table_attention, _v10_vjp_bwd, with_gattn=True).
//
// What it computes, for each bh, from p = attn [K, N] (the map before
// dropout, saved by the forward), the output cotangent g [N, D] and the
// map's own cotangent ga [K, N] (the attention consistency loss reads the
// map), with mask and scale = 1 / (1 - rate) as in the forward:
//     dv[k, :] = sum_n drop(p)[k, n] g[n, :]
//     dp[k, n] = (sum_d v[k, d] g[n, d]) * mask * scale + ga[k, n]
//     c[n]     = sum_k p[k, n] dp[k, n]
//     ds[k, n] = p[k, n] (dp[k, n] - c[n])                 (written out)
//     dq[n, :] = sum_k ds[k, n] k[k, :]
//     dk[k, :] = sum_n ds[k, n] q[n, :]
// all in f32.  ds [BH, K, N] is the cotangent of the bias windows, laid out
// as [BH*K, side, side]; the wrapper (ops/fused_table.py) hands it to
// K1-bwd's kernels (cpb_table_bwd.cu), which scatter it into the table
// cotangent and sum each row's shift cotangent, deterministically.  The TPU
// kernel does that scatter in the same kernel; fusing it here is later
// work.  c[n] is an exact f32 sum, not a product on lower-precision units:
// the softmax backward relies on sum_k ds[k, n] = 0, and the error of a
// rounded c accumulates in the table cotangent's global sum (the note at
// deform_attn.py:2989-2993).
//
// What bounds it on the card: the f32 products, four of K x N x D per bh
// (dp, dv, dq, dk; 5.9 GFLOP at the teacher's shapes, 88 us at 67 TFLOP/s),
// against 158 MB of q, k, v, attn, g, ga, dq, dk, dv and ds (47 us at 3.35
// TB/s), counted from the shapes.
//
// What the design does about that, and why it is deterministic.  On the
// TPU's grid one step per bh works through all N queries; with one block
// per bh only 32 of the 132 SMs would work.  Here S blocks share each bh
// (S = the wrapper's fixed split, 4 at BH = 32, so 128 blocks fill the
// card), and each block walks its own fixed set of 64-query tiles in
// order, with k and v in shared memory: dq of a tile is complete in the
// block that owns it, while dk and dv accumulate in registers (a 10 x 4
// tile per thread each) and are written as one partial per block, summed
// over the S blocks in block order (fixed_order_sum.cuh).  The column sum
// c takes four threads per query, combined in a fixed order.  No atomics:
// two runs on the same inputs give bitwise-equal results.

#include <cstdint>

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"
#include "fused_table.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
fused_table_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ attn,
                       const float* __restrict__ gout,
                       const float* __restrict__ gattn,
                       float* __restrict__ dq, float* __restrict__ ds,
                       float* __restrict__ partial, int BH, int K, int N,
                       int D, uint32_t seed, uint32_t threshold, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int bh = blockIdx.y;
  const int ld = row_stride(D);
  float* s_k = smem;                 // [K, ld]
  float* s_v = s_k + K * ld;         // [K, ld]
  float* s_q = s_v + K * ld;         // [kQT, ld] the q tile
  float* s_g = s_q + kQT * ld;       // [kQT, ld] the g tile
  float* s_gt = s_g + kQT * ld;      // [D, kQT]  the g tile, transposed
  float* s_p = s_gt + D * kQT;       // [K, kQT]  p, then drop(p)
  float* s_ds = s_p + K * kQT;       // [K, kQT]  ga, dp, then ds
  float* s_red = s_ds + K * kQT;     // [4, kQT]

  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  for (int i = threadIdx.x; i < K * D; i += kThreads) {
    const int kk = i / D;
    const int d = i - kk * D;
    s_k[kk * ld + d] = kb[i];
    s_v[kk * ld + d] = vb[i];
  }
  const uint32_t seed_mix = mix32(seed);
  const int dg = threadIdx.x & 15;   // head dims dg*4 .. dg*4+3
  const int rg = threadIdx.x >> 4;   // kv rows rg + 16 i (or queries)
  const bool d_ok = dg * 4 < D;
  float acc_dk[kRows][4];
  float acc_dv[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;
  }

  const int ntiles = (N + kQT - 1) / kQT;
  for (int tile = split; tile < ntiles; tile += S) {
    const int n0 = tile * kQT;
    __syncthreads();  // the previous tile is done with every buffer
    const size_t qoff = (static_cast<size_t>(bh) * N + n0) * D;
    for (int i = threadIdx.x; i < kQT * D; i += kThreads) {
      const int n = i / D;
      const int d = i - n * D;
      const bool in = n0 + n < N;
      const float gv = in ? gout[qoff + i] : 0.0f;
      s_q[n * ld + d] = in ? q[qoff + i] : 0.0f;
      s_g[n * ld + d] = gv;
      s_gt[d * kQT + n] = gv;
    }
    for (int i = threadIdx.x; i < K * kQT; i += kThreads) {
      const int kk = i / kQT;
      const int n = i - kk * kQT;
      const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n0 + n;
      const bool in = n0 + n < N;
      s_p[i] = in ? attn[idx] : 0.0f;
      s_ds[i] = (in && gattn != nullptr) ? gattn[idx] : 0.0f;
    }
    __syncthreads();

    // ---- dp = (v g^T) * mask * scale + ga, a 10 x 4 tile per thread -----
    {
      float acc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      }
      const int cg = dg;  // queries cg*4 .. cg*4+3
      for (int d = 0; d < D; ++d) {
        const float4 gv = *reinterpret_cast<const float4*>(s_gt + d * kQT + cg * 4);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float vv = s_v[min(rg + 16 * i, K - 1) * ld + d];
          acc[i][0] = fmaf(vv, gv.x, acc[i][0]);
          acc[i][1] = fmaf(vv, gv.y, acc[i][1]);
          acc[i][2] = fmaf(vv, gv.z, acc[i][2]);
          acc[i][3] = fmaf(vv, gv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kk = rg + 16 * i;
        if (kk >= K) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg * 4 + j;
          float dp = acc[i][j];
          if (threshold != 0u) {
            const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n0 + c;
            dp = dropout_keep(seed_mix, idx, threshold) ? dp * scale : 0.0f;
          }
          s_ds[kk * kQT + c] += dp;
        }
      }
    }
    __syncthreads();

    // ---- c = sum_k p dp (exact f32, fixed order); ds = p (dp - c) --------
    {
      const int c = threadIdx.x & (kQT - 1);
      const int part = threadIdx.x / kQT;  // 0..3
      float sum = 0.0f;
      for (int kk = part; kk < K; kk += 4) {
        sum += s_p[kk * kQT + c] * s_ds[kk * kQT + c];
      }
      s_red[part * kQT + c] = sum;
      __syncthreads();
      const float cs = ((s_red[c] + s_red[kQT + c]) + s_red[2 * kQT + c]) +
                       s_red[3 * kQT + c];
      const int n = n0 + c;
      for (int kk = part; kk < K; kk += 4) {
        const float p = s_p[kk * kQT + c];
        const float g = p * (s_ds[kk * kQT + c] - cs);
        const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
        s_ds[kk * kQT + c] = g;
        if (n < N) ds[idx] = g;
        if (threshold != 0u) {
          s_p[kk * kQT + c] =
              dropout_keep(seed_mix, idx, threshold) ? p * scale : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- dv += drop(p) g, dk += ds q (registers); dq = ds^T k ------------
    if (d_ok) {
      for (int n = 0; n < kQT; ++n) {
        const float4 gv = *reinterpret_cast<const float4*>(s_g + n * ld + dg * 4);
        const float4 qv = *reinterpret_cast<const float4*>(s_q + n * ld + dg * 4);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int kk = min(rg + 16 * i, K - 1);
          const float pu = s_p[kk * kQT + n];
          const float dsv = s_ds[kk * kQT + n];
          acc_dv[i][0] = fmaf(pu, gv.x, acc_dv[i][0]);
          acc_dv[i][1] = fmaf(pu, gv.y, acc_dv[i][1]);
          acc_dv[i][2] = fmaf(pu, gv.z, acc_dv[i][2]);
          acc_dv[i][3] = fmaf(pu, gv.w, acc_dv[i][3]);
          acc_dk[i][0] = fmaf(dsv, qv.x, acc_dk[i][0]);
          acc_dk[i][1] = fmaf(dsv, qv.y, acc_dk[i][1]);
          acc_dk[i][2] = fmaf(dsv, qv.z, acc_dk[i][2]);
          acc_dk[i][3] = fmaf(dsv, qv.w, acc_dk[i][3]);
        }
      }
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
      for (int kk = 0; kk < K; ++kk) {
        const float4 kv = *reinterpret_cast<const float4*>(s_k + kk * ld + dg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = s_ds[kk * kQT + rg + 16 * i];
          o[i][0] = fmaf(g, kv.x, o[i][0]);
          o[i][1] = fmaf(g, kv.y, o[i][1]);
          o[i][2] = fmaf(g, kv.z, o[i][2]);
          o[i][3] = fmaf(g, kv.w, o[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + rg + 16 * i;
        if (n < N) {
          *reinterpret_cast<float4*>(dq + (static_cast<size_t>(bh) * N + n) * D +
                                     dg * 4) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        }
      }
    }
  }

  // ---- this block's partial dk and dv: [S, 2, BH, K, D] ------------------
  if (d_ok) {
    const size_t plane = static_cast<size_t>(BH) * K * D;
    float* pk = partial + (static_cast<size_t>(split) * 2) * plane +
                static_cast<size_t>(bh) * K * D;
    float* pv = pk + plane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kk = rg + 16 * i;
      if (kk >= K) break;
      *reinterpret_cast<float4*>(pk + kk * D + dg * 4) =
          make_float4(acc_dk[i][0], acc_dk[i][1], acc_dk[i][2], acc_dk[i][3]);
      *reinterpret_cast<float4*>(pv + kk * D + dg * 4) =
          make_float4(acc_dv[i][0], acc_dv[i][1], acc_dv[i][2], acc_dv[i][3]);
    }
  }
}

}  // namespace

// Shared memory of one K6-bwd block, in bytes.
extern "C" int dmlt_fused_table_bwd_smem(int K, int D) {
  const int ld = row_stride(D);
  return static_cast<int>(sizeof(float)) *
         (2 * K * ld + 2 * kQT * ld + D * kQT + 2 * K * kQT + 4 * kQT);
}

// q [BH, N, D] (pre-scaled), k, v [BH, K, D], attn [BH, K, N] (before
// dropout), gout [BH, N, D], gattn [BH, K, N] or null (no map cotangent),
// all f32 -> dq [BH, N, D], dkv [2, BH, K, D] (dk, then dv) and ds
// [BH, K, N], f32.  partial is scratch of splits * 2 * BH * K * D f32;
// split s of a bh takes the 64-query tiles s, s + splits, ...  threshold
// and scale as in dmlt_fused_table_fwd.  Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int dmlt_fused_table_bwd(const void* q, const void* k,
                                    const void* v, const void* attn,
                                    const void* gout, const void* gattn,
                                    void* dq, void* dkv, void* ds,
                                    void* partial, int BH, int K, int N,
                                    int D, int splits, int seed,
                                    int threshold, float scale,
                                    void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (K < 1 || K > kMaxK || D < 4 || D > kMaxD || D % 4 != 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = dmlt_fused_table_bwd_smem(K, D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_table_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_table_bwd_kernel<<<dim3(splits, BH), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(attn),
      static_cast<const float*>(gout), static_cast<const float*>(gattn),
      static_cast<float*>(dq), static_cast<float*>(ds),
      static_cast<float*>(partial), BH, K, N, D, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(threshold), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(partial, splits, 2 * BH * K * D, dkv, s);
}
