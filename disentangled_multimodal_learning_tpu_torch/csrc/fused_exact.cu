// K7-fwd: fused exact-CPB attention (the CPB MLP bias, sim, softmax over
// the kv axis, dropout, PV) in one kernel, with the map in the "nk" or the
// "kn" layout.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _fwd_kernel (the nk tiles behind fused_deform_attention, attn [BH, N, K])
// and _kn_fwd_kernel (v8, behind fused_deform_attention_kn, attn
// [BH, K, N]).
//
// What it computes, for each bh of BH (batch x head), query n of N and kv
// point k of K:
//     bias[n, k] = the CPB MLP of cpb_exact.cuh at grid_q[n] - grid_kv[bh, k]
//     sim[n, k]  = sum_d q[bh, n, d] k[bh, k, d] + bias[n, k]
//     attn[n, k] = softmax over k of sim[n, :]    (written out, either layout)
//     out[n, :]  = sum_k drop(attn)[n, k] v[bh, k, :]
// with q pre-scaled, drop(p) = p / (1 - rate) where the mask keeps the
// element and 0 elsewhere (fused_table.cuh; the element (k, n) has index
// (bh * K + k) * N + n in both layouts, so "nk" and "kn" drop the same
// entries), everything f32.  The bias never leaves the SM.
//
// What bounds it on the card: f32 arithmetic.  The MLP costs ~2.3 k flops
// per (n, k) point, 26 GFLOP at the teacher's shapes (BH = 32, K = 144, N =
// 2500, D = 64); sim and PV add 2 x 2 x 32 x 144 x 2500 x 64 = 2.95 GFLOP;
// 0.43 ms at 67 TFLOP/s outside the tensor cores, against 89 MB of q, k,
// v, out and attn (27 us at 3.35 TB/s), counted from the shapes.
//
// What the design does about that.  The TPU kernels run the MLP as MXU
// matmuls on relaid (T*K, HID) tiles and clamp tiles and K to the TPU's
// (8, 128) layout; none of that carries over.  As K6-fwd (fused_table.cu),
// one block takes one bh and a tile of 64 queries, with k and v in shared
// memory; it first evaluates the tile's K x 64 bias points with the
// weights in shared memory (warp broadcasts) and h1, h2 in registers, into
// the tile's sim buffer, then adds k q^T (a 10 x 4 register tile per
// thread, float4 loads), takes the softmax of each query over its K values
// (four threads per query, combined in a fixed order), stores the map in
// the asked layout (contiguous along n for "kn", along k for "nk": the
// buffer's rows are padded to 65 so that both walks are free of bank
// conflicts), applies the dropout and computes PV.  Any N and any K: the
// kv rows go in chunks of kMaxK = 160 (the register tile of the sim pass).
// With one chunk (the teacher's K = 144) all of it stays in shared memory.
// With more, a first pass over the chunks keeps each query's running max
// and sum of exp and parks sim in the map's place in device memory; a
// second pass reads it back, normalizes it, stores the map and accumulates
// PV.  No TF32, no tensor cores, no library call.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "cpb_exact.cuh"
#include "fused_table.cuh"

namespace {

constexpr int kLdp = kQT + 1;  // row stride of the [K, kQT] sim buffer

// floats of the weights, rounded up so that what follows stays 16-byte
// aligned
constexpr int kMlpFloats = (mlp_floats(1) + 3) & ~3;

// shared memory of a block: k, v, the bias / sim buffer and grid_kv hold
// one chunk of at most kMaxK kv rows
__host__ __device__ inline int fwd_smem_floats(int K, int D) {
  const int kc = K < kMaxK ? K : kMaxK;
  return kMlpFloats + 2 * kc * row_stride(D) + D * kQT +
         ((kc * kLdp + 3) & ~3) + 8 * kQT + 2 * kc + 2 * kQT;
}

// the index of map element (kv row kk, query n) in the asked layout
__device__ __forceinline__ size_t map_index(int nk, int bh, int kk, int n,
                                            int K, int N) {
  return nk ? (static_cast<size_t>(bh) * N + n) * K + kk
            : (static_cast<size_t>(bh) * K + kk) * N + n;
}

// kResident: K <= kMaxK, one chunk of kv rows (the map never leaves shared
// memory); otherwise K > kMaxK in chunks of kMaxK
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
fused_exact_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ grid_q,
                       const float* __restrict__ grid_kv,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ out,
                       float* __restrict__ attn, int K, int N, int D, int nk,
                       uint32_t seed, uint32_t threshold, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kQT;
  const int ld = row_stride(D);
  const int kc = kResident ? K : kMaxK;  // kv rows of a chunk
  const int nchunks = kResident ? 1 : (K + kMaxK - 1) / kMaxK;
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, b3, 1);
  float* s_k = smem + kMlpFloats;               // [kc, ld]
  float* s_v = s_k + kc * ld;                   // [kc, ld]
  float* s_qt = s_v + kc * ld;                  // [D, kQT] the q tile, transposed
  float* s_p = s_qt + D * kQT;                  // [kc, kLdp] bias, sim, p, drop(p)
  float* s_red = s_p + ((kc * kLdp + 3) & ~3);  // [8, kQT]
  float* s_kv = s_red + 8 * kQT;                // [kc, 2] grid_kv of the chunk
  float* s_gq = s_kv + 2 * kc;                  // [kQT, 2] the tile's grid_q

  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  const float* qb = q + static_cast<size_t>(bh) * N * D;
  for (int i = threadIdx.x; i < kQT * D; i += kThreads) {
    const int n = i / D;
    const int d = i - n * D;
    s_qt[d * kQT + n] = (n0 + n < N) ? qb[static_cast<size_t>(n0) * D + i]
                                     : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * kQT; i += kThreads) {
    s_gq[i] = (n0 + i / 2 < N) ? grid_q[2 * n0 + i] : 0.0f;
  }

  // the softmax's thread layout: 4 threads per query, combined in a fixed
  // order; each holds its query's running max and sum of exp
  const int c = threadIdx.x & (kQT - 1);
  const int part = threadIdx.x / kQT;  // 0..3
  float row_max = -INFINITY;
  float row_sum = 0.0f;

  // ---- pass 1, one chunk of kv rows at a time: the bias, sim = k q^T +
  // bias, the running max and sum of exp; with more than one chunk, sim
  // goes to the map's place in device memory until pass 2 -----------------
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * kMaxK;
    const int nrows = kResident ? K : min(kMaxK, K - c0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
      const int kk = i / D;
      const int d = i - kk * D;
      s_k[kk * ld + d] = kb[static_cast<size_t>(c0) * D + i];
      if (kResident) s_v[kk * ld + d] = vb[i];
    }
    for (int i = threadIdx.x; i < 2 * nrows; i += kThreads) {
      s_kv[i] = grid_kv[(static_cast<size_t>(bh) * K + c0) * 2 + i];
    }
    __syncthreads();

    // the bias of the chunk's nrows x kQT points
    for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {
      const int kk = i / kQT;
      const int cc = i - kk * kQT;
      const float fx = signed_log1p(s_gq[2 * cc] - s_kv[2 * kk]);
      const float fy = signed_log1p(s_gq[2 * cc + 1] - s_kv[2 * kk + 1]);
      float h1[kHid];
      float h2[kHid];
      mlp_hidden(m, fx, fy, h1, h2);
      s_p[kk * kLdp + cc] = mlp_out(m, h2, 0, 1);
    }
    __syncthreads();

    // sim = k q^T + bias, a 10 x 4 tile per thread
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
          const float kv = s_k[min(rg + 16 * i, nrows - 1) * ld + d];
          acc[i][0] = fmaf(kv, qv.x, acc[i][0]);
          acc[i][1] = fmaf(kv, qv.y, acc[i][1]);
          acc[i][2] = fmaf(kv, qv.z, acc[i][2]);
          acc[i][3] = fmaf(kv, qv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kk = rg + 16 * i;
        if (kk >= nrows) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s = s_p + kk * kLdp + cg * 4 + j;
          *s = acc[i][j] + *s;
        }
      }
    }
    __syncthreads();

    // the running max and sum of exp over the kv axis (with one chunk: the
    // max, then the sum of exp(sim - max), which stays in s_p)
    float mx = -INFINITY;
    for (int kk = part; kk < nrows; kk += 4) mx = fmaxf(mx, s_p[kk * kLdp + c]);
    s_red[part * kQT + c] = mx;
    __syncthreads();
    mx = fmaxf(row_max, fmaxf(fmaxf(s_red[c], s_red[kQT + c]),
                              fmaxf(s_red[2 * kQT + c], s_red[3 * kQT + c])));
    float sum = 0.0f;
    for (int kk = part; kk < nrows; kk += 4) {
      const float e = expf(s_p[kk * kLdp + c] - mx);
      if (kResident) s_p[kk * kLdp + c] = e;
      sum += e;
    }
    s_red[(4 + part) * kQT + c] = sum;
    __syncthreads();
    sum = ((s_red[4 * kQT + c] + s_red[5 * kQT + c]) + s_red[6 * kQT + c]) +
          s_red[7 * kQT + c];
    row_sum = row_sum * expf(row_max - mx) + sum;  // the first chunk: sum
    row_max = mx;
    if (!kResident) {
      for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {
        const int kk = nk ? i % nrows : i / kQT;
        const int cc = nk ? i / nrows : i % kQT;
        if (n0 + cc < N) {
          attn[map_index(nk, bh, c0 + kk, n0 + cc, K, N)] = s_p[kk * kLdp + cc];
        }
      }
    }
  }

  // ---- pass 2, chunk by chunk: p = exp(sim - max) / sum, the map before
  // dropout in the asked layout, the dropout, then out += drop(p)^T v -----
  const uint32_t seed_mix = mix32(seed);
  const int dg = threadIdx.x & 15;  // head dims dg*4 .. dg*4+3
  const int ng = threadIdx.x >> 4;  // queries ng + 16 i
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * kMaxK;
    const int nrows = kResident ? K : min(kMaxK, K - c0);
    if (kResident) {
      for (int kk = part; kk < nrows; kk += 4) s_p[kk * kLdp + c] /= row_sum;
    } else {
      __syncthreads();  // the previous chunk is done with s_v and s_p
      for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
        const int kk = i / D;
        s_v[kk * ld + i - kk * D] = vb[static_cast<size_t>(c0) * D + i];
      }
      for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {
        const int kk = nk ? i % nrows : i / kQT;
        const int cc = nk ? i / nrows : i % kQT;
        s_p[kk * kLdp + cc] =
            (n0 + cc < N) ? attn[map_index(nk, bh, c0 + kk, n0 + cc, K, N)]
                          : 0.0f;
      }
      __syncthreads();
      for (int kk = part; kk < nrows; kk += 4) {
        s_p[kk * kLdp + c] = expf(s_p[kk * kLdp + c] - row_max) / row_sum;
      }
    }
    __syncthreads();

    // the map before dropout (contiguous along n for "kn", along k for
    // "nk"); then the dropout of element (c0 + kk, n), the same in both
    for (int i = threadIdx.x; i < nrows * kQT; i += kThreads) {
      const int kk = nk ? i % nrows : i / kQT;
      const int cc = nk ? i / nrows : i % kQT;
      const int n = n0 + cc;
      float* s = s_p + kk * kLdp + cc;
      const float p = *s;
      if (n < N) attn[map_index(nk, bh, c0 + kk, n, K, N)] = p;
      if (threshold != 0u) {
        const size_t idx = (static_cast<size_t>(bh) * K + c0 + kk) * N + n;
        *s = dropout_keep(seed_mix, idx, threshold) ? p * scale : 0.0f;
      }
    }
    __syncthreads();

    // out += drop(p)^T v, a 4 x 4 tile per thread
    if (dg * 4 < D) {
      for (int kk = 0; kk < nrows; ++kk) {
        const float4 vv = *reinterpret_cast<const float4*>(s_v + kk * ld + dg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = s_p[kk * kLdp + ng + 16 * i];
          o[i][0] = fmaf(p, vv.x, o[i][0]);
          o[i][1] = fmaf(p, vv.y, o[i][1]);
          o[i][2] = fmaf(p, vv.z, o[i][2]);
          o[i][3] = fmaf(p, vv.w, o[i][3]);
        }
      }
    }
  }
  if (dg * 4 < D) {
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

}  // namespace

// Shared memory of one K7-fwd block, in bytes.
extern "C" int dmlt_fused_exact_fwd_smem(int K, int D) {
  return static_cast<int>(sizeof(float)) * fwd_smem_floats(K, D);
}

// q [BH, N, D] (pre-scaled), k, v [BH, K, D], grid_q [N, 2], grid_kv
// [BH, K, 2], the CPB weights w1 [2, 32], b1 [32], w2 [32, 32], b2 [32], w3
// [32, 1], b3 [1], all f32 -> out [BH, N, D] and attn (before dropout)
// [BH, N, K] (nk = 1) or [BH, K, N] (nk = 0), f32.  threshold = round(rate
// * 2^24) (0: no dropout), scale = 1 / (1 - rate).  Any K; D <= 64 and a
// multiple of 4.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int dmlt_fused_exact_fwd(const void* q, const void* k,
                                    const void* v, const void* grid_q,
                                    const void* grid_kv, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, void* attn,
                                    int BH, int K, int N, int D, int nk,
                                    int seed, int threshold, float scale,
                                    void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (K < 1 || D < 4 || D > kMaxD || D % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = dmlt_fused_exact_fwd_smem(K, D);
  const auto kernel = K <= kMaxK ? fused_exact_fwd_kernel<true>
                                 : fused_exact_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQT - 1) / kQT, BH);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(grid_q),
      static_cast<const float*>(grid_kv), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out),
      static_cast<float*>(attn), K, N, D, nk, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(threshold), scale);
  return static_cast<int>(cudaGetLastError());
}
