// The attention backward that K6-bwd (fused_table_bwd.cu) and K7-bwd
// (fused_exact_bwd.cu) share: everything of the fused attentions' gradient
// up to the bias cotangent ds, which each hands to the kernels of its own
// bias (K6: K1-bwd's table scatter; K7: K2-bwd's MLP backward).
//
// What it computes, for each bh, from p = attn (the map before dropout,
// saved by the forward; [K, N] in "kn", [N, K] in "nk"), the output
// cotangent g [N, D] and the map's own cotangent ga (laid out as attn; the
// attention consistency loss reads the map), with mask and scale = 1 /
// (1 - rate) as in the forwards (the mask of element (k, n) is the same in
// both layouts, fused_table.cuh):
//     dv[k, :] = sum_n drop(p)[k, n] g[n, :]
//     dp[k, n] = (sum_d v[k, d] g[n, d]) * mask * scale + ga[k, n]
//     c[n]     = sum_k p[k, n] dp[k, n]
//     ds[k, n] = p[k, n] (dp[k, n] - c[n])                 (written out)
//     dq[n, :] = sum_k ds[k, n] k[k, :]
//     dk[k, :] = sum_n ds[k, n] q[n, :]
// all in f32; ds is written as [BH, K, N] in either layout.  c[n] is an
// exact f32 sum, not a product on lower-precision units: the softmax
// backward relies on sum_k ds[k, n] = 0, and the error of a rounded c
// accumulates in the bias parameters' cotangents (the note at
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
// c takes four threads per query, combined in a fixed order.  That holds
// for K <= kMaxK = 160 (K6 always; K7 at the teacher's K = 144).  K7 takes
// any K: then the kv rows go in chunks of kMaxK, k and v chunks come from
// device memory for each tile, a first pass over the chunks computes dp
// and c and parks dp in ds, a second turns it into ds, and each tile adds
// its dk and dv of a chunk's rows into the block's partial in device memory
// (which only that block touches), in tile order.  No atomics: two runs on
// the same inputs give bitwise-equal results.
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"
#include "fused_table.cuh"

namespace {

// kResident: K <= kMaxK, one chunk of kv rows (k, v, dk, dv stay on the
// SM); otherwise K > kMaxK in chunks of kMaxK
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
fused_attention_bwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ attn,
                           const float* __restrict__ gout,
                           const float* __restrict__ gattn,
                           float* __restrict__ dq, float* __restrict__ ds,
                           float* __restrict__ partial, int BH, int K, int N,
                           int D, int nk, uint32_t seed, uint32_t threshold,
                           float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int bh = blockIdx.y;
  const int ld = row_stride(D);
  const int kc = kResident ? K : kMaxK;  // kv rows of a chunk
  const int nchunks = kResident ? 1 : (K + kMaxK - 1) / kMaxK;
  float* s_k = smem;                 // [kc, ld]
  float* s_v = s_k + kc * ld;        // [kc, ld]
  float* s_q = s_v + kc * ld;        // [kQT, ld] the q tile
  float* s_g = s_q + kQT * ld;       // [kQT, ld] the g tile
  float* s_gt = s_g + kQT * ld;      // [D, kQT]  the g tile, transposed
  float* s_p = s_gt + D * kQT;       // [kc, kQT] p, then drop(p)
  float* s_ds = s_p + kc * kQT;      // [kc, kQT] ga, dp, then ds
  float* s_red = s_ds + kc * kQT;    // [4, kQT]

  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  if (kResident) {
    for (int i = threadIdx.x; i < K * D; i += kThreads) {
      const int kk = i / D;
      const int d = i - kk * D;
      s_k[kk * ld + d] = kb[i];
      s_v[kk * ld + d] = vb[i];
    }
  }
  const uint32_t seed_mix = mix32(seed);
  const int dg = threadIdx.x & 15;   // head dims dg*4 .. dg*4+3
  const int rg = threadIdx.x >> 4;   // kv rows rg + 16 i (or queries)
  const bool d_ok = dg * 4 < D;
  const int c = threadIdx.x & (kQT - 1);  // the column sums: 4 threads
  const int part = threadIdx.x / kQT;     // per query, 0..3
  const size_t plane = static_cast<size_t>(BH) * K * D;
  float* pk = partial + (static_cast<size_t>(split) * 2) * plane +
              static_cast<size_t>(bh) * K * D;  // this block's dk partial
  float* pv = pk + plane;                       // and dv partial
  float acc_dk[kRows][4];
  float acc_dv[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;
  }

  // p and ga of the nrows kv rows from c0, for the tile at n0, into s_p and
  // s_ds
  auto load_map = [&](int n0, int c0, int nrows, bool with_ga) {
    for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {
      // "nk": the map is [BH, N, K]; i runs along k so that the loads are
      // contiguous
      const int kk = nk ? i % nrows : i / kQT;
      const int n = nk ? i / nrows : i % kQT;
      const size_t idx =
          nk ? (static_cast<size_t>(bh) * N + n0 + n) * K + c0 + kk
             : (static_cast<size_t>(bh) * K + c0 + kk) * N + n0 + n;
      const bool in = n0 + n < N;
      s_p[kk * kQT + n] = in ? attn[idx] : 0.0f;
      if (with_ga) {
        s_ds[kk * kQT + n] = (in && gattn != nullptr) ? gattn[idx] : 0.0f;
      }
    }
  };
  // rows c0 .. c0 + nrows of k or v into s
  auto load_rows = [&](float* s, const float* src, int c0, int nrows) {
    for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
      const int kk = i / D;
      s[kk * ld + i - kk * D] = src[static_cast<size_t>(c0) * D + i];
    }
  };

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

    // ---- pass A, one chunk of kv rows at a time: dp = (v g^T) * mask *
    // scale + ga, a 10 x 4 tile per thread; the column sum c = sum_k p dp
    // (exact f32, fixed order); with more than one chunk, dp goes to ds in
    // device memory until pass B -------------------------------------------
    float csum = 0.0f;
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * kMaxK;
      const int nrows = kResident ? K : min(kMaxK, K - c0);
      if (!kResident) {
        __syncthreads();  // the previous chunk is done with s_v, s_p, s_ds
        load_rows(s_v, vb, c0, nrows);
      }
      load_map(n0, c0, nrows, true);
      __syncthreads();
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
            const float vv = s_v[min(rg + 16 * i, nrows - 1) * ld + d];
            acc[i][0] = fmaf(vv, gv.x, acc[i][0]);
            acc[i][1] = fmaf(vv, gv.y, acc[i][1]);
            acc[i][2] = fmaf(vv, gv.z, acc[i][2]);
            acc[i][3] = fmaf(vv, gv.w, acc[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int kk = rg + 16 * i;
          if (kk >= nrows) break;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cc = cg * 4 + j;
            float dp = acc[i][j];
            if (threshold != 0u) {
              const size_t idx =
                  (static_cast<size_t>(bh) * K + c0 + kk) * N + n0 + cc;
              dp = dropout_keep(seed_mix, idx, threshold) ? dp * scale : 0.0f;
            }
            s_ds[kk * kQT + cc] += dp;
          }
        }
      }
      __syncthreads();
      for (int kk = part; kk < nrows; kk += 4) {
        const float dp = s_ds[kk * kQT + c];
        csum += s_p[kk * kQT + c] * dp;
        if (!kResident && n0 + c < N) {
          ds[(static_cast<size_t>(bh) * K + c0 + kk) * N + n0 + c] = dp;
        }
      }
    }
    s_red[part * kQT + c] = csum;
    __syncthreads();
    const float cs = ((s_red[c] + s_red[kQT + c]) + s_red[2 * kQT + c]) +
                     s_red[3 * kQT + c];

    // ---- pass B, chunk by chunk: ds = p (dp - c) (written out); dv +=
    // drop(p) g and dk += ds q (registers), dq += ds^T k --------------------
    float o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * kMaxK;
      const int nrows = kResident ? K : min(kMaxK, K - c0);
      if (!kResident) {
        __syncthreads();  // the previous pass or chunk is done with them
        load_rows(s_k, kb, c0, nrows);
        load_map(n0, c0, nrows, false);
        __syncthreads();
      }
      const int n = n0 + c;
      for (int kk = part; kk < nrows; kk += 4) {
        const size_t idx = (static_cast<size_t>(bh) * K + c0 + kk) * N + n;
        const float p = s_p[kk * kQT + c];
        const float dp =
            kResident ? s_ds[kk * kQT + c] : (n < N ? ds[idx] : 0.0f);
        const float g = p * (dp - cs);
        s_ds[kk * kQT + c] = g;
        if (n < N) ds[idx] = g;
        if (threshold != 0u) {
          s_p[kk * kQT + c] =
              dropout_keep(seed_mix, idx, threshold) ? p * scale : 0.0f;
        }
      }
      __syncthreads();

      if (d_ok) {
        if (!kResident) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;
          }
        }
        for (int nn = 0; nn < kQT; ++nn) {
          const float4 gv = *reinterpret_cast<const float4*>(s_g + nn * ld + dg * 4);
          const float4 qv = *reinterpret_cast<const float4*>(s_q + nn * ld + dg * 4);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int kk = min(rg + 16 * i, nrows - 1);
            const float pu = s_p[kk * kQT + nn];
            const float dsv = s_ds[kk * kQT + nn];
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
        for (int kk = 0; kk < nrows; ++kk) {
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
        if (!kResident) {
          // this tile's dk and dv of the chunk's rows into the block's
          // partial (its first tile writes it), in tile order
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int kk = rg + 16 * i;
            if (kk >= nrows) break;
            float4* a = reinterpret_cast<float4*>(pk + (c0 + kk) * D + dg * 4);
            float4* b = reinterpret_cast<float4*>(pv + (c0 + kk) * D + dg * 4);
            float4 x = make_float4(acc_dk[i][0], acc_dk[i][1], acc_dk[i][2],
                                   acc_dk[i][3]);
            float4 y = make_float4(acc_dv[i][0], acc_dv[i][1], acc_dv[i][2],
                                   acc_dv[i][3]);
            if (tile != split) {
              const float4 xa = *a;
              const float4 ya = *b;
              x = make_float4(xa.x + x.x, xa.y + x.y, xa.z + x.z, xa.w + x.w);
              y = make_float4(ya.x + y.x, ya.y + y.y, ya.z + y.z, ya.w + y.w);
            }
            *a = x;
            *b = y;
          }
        }
      }
    }
    if (d_ok) {
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

  // ---- with one chunk, this block's partial dk and dv from the registers
  if (d_ok && kResident) {
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

namespace {

// Shared memory of one block of fused_attention_bwd_kernel, in bytes.
inline int fused_attention_bwd_smem(int K, int D) {
  const int ld = row_stride(D);
  const int kc = K < kMaxK ? K : kMaxK;
  return static_cast<int>(sizeof(float)) *
         (2 * kc * ld + 2 * kQT * ld + D * kQT + 2 * kc * kQT + 4 * kQT);
}

// Launches the kernel and the block-order sum of its dk / dv partials on
// stream; returns cudaGetLastError().  q [BH, N, D] (pre-scaled), k, v
// [BH, K, D], attn and gattn (or null) [BH, K, N] ("kn") or [BH, N, K]
// ("nk"), gout [BH, N, D], all f32 -> dq [BH, N, D], dkv [2, BH, K, D] (dk,
// then dv) and ds [BH, K, N].  partial is scratch of splits * 2 * BH * K *
// D f32; split s of a bh takes the 64-query tiles s, s + splits, ...
inline int fused_attention_bwd(const void* q, const void* k, const void* v,
                               const void* attn, const void* gout,
                               const void* gattn, void* dq, void* dkv,
                               void* ds, void* partial, int BH, int K, int N,
                               int D, int splits, int nk, int seed,
                               int threshold, float scale,
                               cudaStream_t s) {
  if (BH == 0 || N == 0) return 0;
  if (K < 1 || D < 4 || D > kMaxD || D % 4 != 0 || splits < 1 ||
      splits > (N + kQT - 1) / kQT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = fused_attention_bwd_smem(K, D);
  const auto kernel = K <= kMaxK ? fused_attention_bwd_kernel<true>
                                 : fused_attention_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, BH), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(attn),
      static_cast<const float*>(gout), static_cast<const float*>(gattn),
      static_cast<float*>(dq), static_cast<float*>(ds),
      static_cast<float*>(partial), BH, K, N, D, nk,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(threshold), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(partial, splits, 2 * BH * K * D, dkv, s);
}

}  // namespace
