// K6-fwd: fused divisor-1 table attention (bias windows, sim, softmax over
// the kv axis, dropout, PV) in one kernel.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _v10_fwd_kernel (the TPU kernel behind fused_table_attention, the
// cfg.fused_table_attention path of DeformCrossAttention2D).
//
// What it computes, for each bh of BH (batch x head) and query n of N =
// side^2 (qy = n / side, qx = n % side), over the K kv points of the row
// r = bh * K + k with taps (y0, x0) and fractions (fy, fx):
//     bias[k, n] = K1's window value (y, x) = (qy, qx) of row r
//     sim[k, n]  = sum_d k[bh, k, d] q[bh, n, d] + bias[k, n]
//     attn[k, n] = softmax over k of sim[:, n]          (written out)
//     out[n, :]  = sum_k drop(attn)[k, n] v[bh, k, :]
// with q pre-scaled, drop(p) = p / (1 - rate) where the mask keeps the
// element and 0 elsewhere (fused_table.cuh), everything f32.  The bias is
// never written to device memory in any layout.
//
// What bounds it on the card: the f32 products.  At the teacher's shapes
// (BH = 32, K = 144, N = 2500, D = 64) sim and PV are 2 x 32 x 144 x 2500 x
// 64 multiply-adds (2.95 GFLOP, 44 us at 67 TFLOP/s outside the tensor
// cores), against 89 MB of q, k, v, out and attn (27 us at 3.35 TB/s),
// counted from the shapes.
//
// What the design does about that.  The TPU kernel walks the query axis in
// 256-lane groups of one grid step per bh and places window rows by static
// lane rolls; those are TPU layout rules (the v10_supported gate), and
// none of them carries over.  Here one block takes one bh and a tile of 64
// queries, with the divisor-1 table (139^2 f32 = 77 KB at side 50), k and
// v in shared memory (213 KB in all at the teacher's shapes, one block per
// SM), and computes the bias on the fly with K1's arithmetic (each product
// and sum rounded separately, as ops/cpb.py table_interp_reference rounds
// them).  Both products keep a 10 x 4 (sim) or 4 x 4 (PV) register tile
// per thread, read from shared memory with float4 loads.  The softmax
// reduces each query's 144 values in f32: four threads per query, combined
// in a fixed order, so the result does not depend on scheduling.  No TF32,
// no tensor cores, no library call.  Making it fast (tensor-core products
// at bf16, a persistent grid) is later work.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_table.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 1)
fused_table_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ table, int tn_rows,
                       int tn_cols, const int* __restrict__ taps,
                       const float* __restrict__ fracs,
                       float* __restrict__ out, float* __restrict__ attn,
                       int K, int N, int D, int side, uint32_t seed,
                       uint32_t threshold, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kQT;
  const int ld = row_stride(D);
  const int tsize = tn_rows * tn_cols;
  float* s_tab = smem;                          // [tn_rows, tn_cols]
  float* s_k = s_tab + ((tsize + 3) & ~3);      // [K, ld]
  float* s_v = s_k + K * ld;                    // [K, ld]
  float* s_qt = s_v + K * ld;                   // [D, kQT] the q tile, transposed
  float* s_p = s_qt + D * kQT;                  // [K, kQT] sim, p, dropped p
  float* s_red = s_p + K * kQT;                 // [8, kQT]
  int* s_y0 = reinterpret_cast<int*>(s_red + 8 * kQT);  // [K] each
  int* s_x0 = s_y0 + K;
  float* s_fy = reinterpret_cast<float*>(s_x0 + K);
  float* s_fx = s_fy + K;

  for (int i = threadIdx.x; i < tsize; i += kThreads) s_tab[i] = table[i];
  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  for (int i = threadIdx.x; i < K * D; i += kThreads) {
    const int kk = i / D;
    const int d = i - kk * D;
    s_k[kk * ld + d] = kb[i];
    s_v[kk * ld + d] = vb[i];
  }
  const float* qb = q + static_cast<size_t>(bh) * N * D;
  for (int i = threadIdx.x; i < kQT * D; i += kThreads) {
    const int n = i / D;
    const int d = i - n * D;
    s_qt[d * kQT + n] = (n0 + n < N) ? qb[static_cast<size_t>(n0) * D + i]
                                     : 0.0f;
  }
  for (int kk = threadIdx.x; kk < K; kk += kThreads) {
    const int r = bh * K + kk;
    // the taps are clipped on the host side; clamping again keeps a bad
    // tap from reading outside the table
    s_y0[kk] = min(max(taps[2 * r], 0), tn_rows - side - 1);
    s_x0[kk] = min(max(taps[2 * r + 1], 0), tn_cols - side - 1);
    s_fy[kk] = fracs[2 * r];
    s_fx[kk] = fracs[2 * r + 1];
  }
  __syncthreads();

  // ---- sim = k q^T + bias, a 10 x 4 tile per thread ---------------------
  {
    const int cg = threadIdx.x & 15;  // queries cg*4 .. cg*4+3
    const int rg = threadIdx.x >> 4;  // kv rows rg + 16 i
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(s_qt + d * kQT + cg * 4);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float kv = s_k[min(rg + 16 * i, K - 1) * ld + d];
        acc[i][0] = fmaf(kv, qv.x, acc[i][0]);
        acc[i][1] = fmaf(kv, qv.y, acc[i][1]);
        acc[i][2] = fmaf(kv, qv.z, acc[i][2]);
        acc[i][3] = fmaf(kv, qv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kk = rg + 16 * i;
      if (kk >= K) break;
      const float fy = s_fy[kk];
      const float fx = s_fx[kk];
      const float gy = __fsub_rn(1.0f, fy);
      const float gx = __fsub_rn(1.0f, fx);
      const float* base = s_tab + s_y0[kk] * tn_cols + s_x0[kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + cg * 4 + j;
        float s = acc[i][j];
        if (n < N) {
          const int qy = n / side;
          const float* t = base + qy * tn_cols + (n - qy * side);
          const float a = __fadd_rn(__fmul_rn(t[0], gy),
                                    __fmul_rn(t[tn_cols], fy));
          const float b = __fadd_rn(__fmul_rn(t[1], gy),
                                    __fmul_rn(t[tn_cols + 1], fy));
          s = __fadd_rn(s, __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));
        }
        s_p[kk * kQT + cg * 4 + j] = s;
      }
    }
  }
  __syncthreads();

  // ---- softmax over the kv axis: 4 threads per query, fixed order -------
  {
    const int c = threadIdx.x & (kQT - 1);
    const int part = threadIdx.x / kQT;  // 0..3
    float m = -INFINITY;
    for (int kk = part; kk < K; kk += 4) m = fmaxf(m, s_p[kk * kQT + c]);
    s_red[part * kQT + c] = m;
    __syncthreads();
    m = fmaxf(fmaxf(s_red[c], s_red[kQT + c]),
              fmaxf(s_red[2 * kQT + c], s_red[3 * kQT + c]));
    float sum = 0.0f;
    for (int kk = part; kk < K; kk += 4) {
      const float e = expf(s_p[kk * kQT + c] - m);
      s_p[kk * kQT + c] = e;
      sum += e;
    }
    s_red[(4 + part) * kQT + c] = sum;
    __syncthreads();
    sum = ((s_red[4 * kQT + c] + s_red[5 * kQT + c]) + s_red[6 * kQT + c]) +
          s_red[7 * kQT + c];
    const int n = n0 + c;
    const uint32_t seed_mix = mix32(seed);
    for (int kk = part; kk < K; kk += 4) {
      float p = s_p[kk * kQT + c] / sum;
      const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
      if (n < N) attn[idx] = p;  // the map before dropout
      if (threshold != 0u) {
        p = dropout_keep(seed_mix, idx, threshold) ? p * scale : 0.0f;
      }
      s_p[kk * kQT + c] = p;
    }
  }
  __syncthreads();

  // ---- out = drop(p)^T v, a 4 x 4 tile per thread -----------------------
  {
    const int dg = threadIdx.x & 15;  // head dims dg*4 .. dg*4+3
    const int ng = threadIdx.x >> 4;  // queries ng + 16 i
    if (dg * 4 < D) {
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
      for (int kk = 0; kk < K; ++kk) {
        const float4 vv = *reinterpret_cast<const float4*>(s_v + kk * ld + dg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = s_p[kk * kQT + ng + 16 * i];
          o[i][0] = fmaf(p, vv.x, o[i][0]);
          o[i][1] = fmaf(p, vv.y, o[i][1]);
          o[i][2] = fmaf(p, vv.z, o[i][2]);
          o[i][3] = fmaf(p, vv.w, o[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + ng + 16 * i;
        if (n < N) {
          *reinterpret_cast<float4*>(out + (static_cast<size_t>(bh) * N + n) * D +
                                     dg * 4) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        }
      }
    }
  }
}

}  // namespace

// Shared memory of one K6-fwd block, in bytes.
extern "C" int dmlt_fused_table_fwd_smem(int tn_rows, int tn_cols, int K,
                                         int D) {
  const int tsize = (tn_rows * tn_cols + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (tsize + 2 * K * row_stride(D) + D * kQT + K * kQT + 8 * kQT + 4 * K);
}

// q [BH, N, D] (pre-scaled), k, v [BH, K, D], table [tn_rows, tn_cols],
// taps [BH*K, 2] int32, fracs [BH*K, 2], all f32 but taps -> out [BH, N, D]
// and attn [BH, K, N] (before dropout), f32.  threshold = round(rate *
// 2^24) (0: no dropout), scale = 1 / (1 - rate).  Needs K <= 160, D <= 64
// and a multiple of 4, N = side^2.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int dmlt_fused_table_fwd(const void* q, const void* k,
                                    const void* v, const void* table,
                                    int tn_rows, int tn_cols,
                                    const void* taps, const void* fracs,
                                    void* out, void* attn, int BH, int K,
                                    int N, int D, int side, int seed,
                                    int threshold, float scale,
                                    void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (K < 1 || K > kMaxK || D < 4 || D > kMaxD || D % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = dmlt_fused_table_fwd_smem(tn_rows, tn_cols, K, D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_table_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQT - 1) / kQT, BH);
  fused_table_fwd_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table), tn_rows,
      tn_cols, static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<float*>(out), static_cast<float*>(attn), K, N, D, side,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(threshold), scale);
  return static_cast<int>(cudaGetLastError());
}
