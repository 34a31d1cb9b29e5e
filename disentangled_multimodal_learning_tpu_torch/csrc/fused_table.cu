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
// What bounds it on the card.  At the teacher's shapes (BH = 32, K = 144,
// N = 2500, D = 64) sim and PV are 2 x 32 x 144 x 2500 x 64 multiply-adds,
// three tensor-core passes each here (8.8 GFLOP of TF32, 18 us at 495
// TFLOP/s), against 89 MB of q, k, v, out and attn (27 us at 3.35 TB/s),
// counted from the shapes: the bytes, with the softmax's exp, the bias
// blend and the dropout hash on the CUDA cores beside them.
//
// What the design does about that.  The TPU kernel walks the query axis in
// 256-lane groups of one grid step per bh and places window rows by static
// lane rolls; those are TPU layout rules (the v10_supported gate), and
// none of them carries over.  Here a fixed number of blocks share a bh (a
// function of BH alone, 4 at BH = 32), each of 16 warps, one block an SM
// (187 KB of shared memory at K = 144, D = 64); a block stages k and v
// once and walks its own 32-query tiles, the next q tile loading by
// cp.async while this one computes.  Both products run on the tensor cores
// as 3xTF32 mma.sync (tf32_mma.cuh: f32-accurate): sim as K x 32 in 16 x 8
// fragments (a warp takes up to three m16 tiles of kv rows and one n8 tile
// of queries; the four warps of a row group issue on the four schedulers),
// PV as 32 x D (a warp one 16 x 8 tile over all kv rows, in four chains of
// mma.sync).  k and drop(p), which several warps read, are split into TF32
// hi and lo once, as they are written to shared memory; q and v as they
// are read.  The rest stays on the CUDA cores in f32, as the plain version
// rounds it: the bias with K1's arithmetic (each product and sum rounded
// separately, as ops/cpb.py table_interp_reference rounds them), added to
// sim in the fragment's registers, the y-blend of a tap column shared by
// the two queries of a lane and, by a shuffle, with the lane holding the
// next pair (K1 blends query x + 1's left column as query x's right one);
// the softmax's max, exp and sum over the kv rows of a query (warp
// shuffles over a fragment's rows, then the four row groups' partials in a
// fixed order, so the result does not depend on scheduling); the dropout
// hash on the element index.  The 139^2 f32 table (77 KB at side 50) is
// read through L1: shared memory holds the split operands instead.  K is
// padded to 16 rows and D to 8 columns with zeros in shared memory, and the
// query tail is masked.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_table.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kFwdWarps = 16;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBlocks = 132;  // blocks over all bh: one an H100 SM
constexpr int kTQ = 32;          // queries of a tile
constexpr int kRowGroups = 4;    // sim: warps along the kv rows
constexpr int kMT = (kMaxK / 16 + kRowGroups - 1) / kRowGroups;  // m16 tiles a warp
constexpr int kLdp = kTQ + 8;    // row stride of drop(p) [Kp, kTQ]

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }

// shared floats of a block; the row strides keep each fragment read free
// of bank conflicts at D = 64 (k and q rows 4 mod 32 banks apart, v and
// drop(p) rows 8)
__host__ __device__ inline int fwd_smem_floats(int K, int D) {
  const int Kp = pad16(K);
  const int Dp = pad8(D);
  return 2 * Kp * (Dp + 4) + Kp * (Dp + 8) + 2 * kTQ * (Dp + 4) +
         2 * Kp * kLdp + 2 * kRowGroups * kTQ + 4 * Kp;
}

__global__ void __launch_bounds__(kFwdThreads, 1)
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
  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int bh = blockIdx.y;
  const int Kp = pad16(K);
  const int Dp = pad8(D);
  const int ldk = Dp + 4;
  const int ldv = Dp + 8;
  const int ldq = Dp + 4;
  // k and drop(p) are split into TF32 hi and lo once, as they are
  // written: each value is read by several warps
  uint32_t* s_khi = reinterpret_cast<uint32_t*>(smem);  // [Kp, ldk] each
  uint32_t* s_klo = s_khi + Kp * ldk;
  float* s_v = reinterpret_cast<float*>(s_klo + Kp * ldk);  // [Kp, ldv]
  float* s_q = s_v + Kp * ldv;              // [2, kTQ, ldq] the q tiles
  uint32_t* s_phi = reinterpret_cast<uint32_t*>(s_q + 2 * kTQ * ldq);
  uint32_t* s_plo = s_phi + Kp * kLdp;      // [Kp, kLdp] each: drop(p)
  float* s_max = reinterpret_cast<float*>(s_plo + Kp * kLdp);  // [kRowGroups, kTQ]
  float* s_sum = s_max + kRowGroups * kTQ;  // [kRowGroups, kTQ]
  int* s_y0 = reinterpret_cast<int*>(s_sum + kRowGroups * kTQ);  // [Kp] each
  int* s_x0 = s_y0 + Kp;
  float* s_fy = reinterpret_cast<float*>(s_x0 + Kp);
  float* s_fx = s_fy + Kp;

  const float* qb = q + static_cast<size_t>(bh) * N * D;
  const int chunks = D / 4;  // 16-byte pieces of a q row
  // the q tile of `tile` into buffer buf, asynchronously, zeros past N
  auto load_q = [&](int tile, int buf) {
    const int n0 = tile * kTQ;
    float* dst = s_q + buf * kTQ * ldq;
    for (int i = threadIdx.x; i < kTQ * chunks; i += kFwdThreads) {
      const int n = i / chunks;
      const int c = i - n * chunks;
      const bool in = n0 + n < N;
      cp_async16(dst + n * ldq + 4 * c,
                 qb + static_cast<size_t>(in ? n0 + n : 0) * D + 4 * c, in);
    }
    cp_async_commit();
  };
  load_q(split, 0);  // in flight while k, v and the taps are staged

  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  for (int i = threadIdx.x; i < Kp * Dp; i += kFwdThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const bool in = r < K && d < D;
    split_tf32(in ? kb[r * D + d] : 0.0f, s_khi[r * ldk + d],
               s_klo[r * ldk + d]);
    s_v[r * ldv + d] = in ? vb[r * D + d] : 0.0f;
  }
  // the q tiles' padding columns D .. Dp, which cp.async never writes
  for (int i = threadIdx.x; i < 2 * kTQ * (Dp - D); i += kFwdThreads) {
    const int row = i / (Dp - D);
    s_q[row * ldq + D + i - row * (Dp - D)] = 0.0f;
  }
  for (int kk = threadIdx.x; kk < K; kk += kFwdThreads) {
    const int r = bh * K + kk;
    // the taps are clipped on the host side; clamping again keeps a bad
    // tap from reading outside the table
    s_y0[kk] = min(max(taps[2 * r], 0), tn_rows - side - 1);
    s_x0[kk] = min(max(taps[2 * r + 1], 0), tn_cols - side - 1);
    s_fy[kk] = fracs[2 * r];
    s_fx[kk] = fracs[2 * r + 1];
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragments' row group
  const int t = lane & 3;   // and the lane within it
  // (warp w issues on scheduler w % 4, so each scheduler takes one warp
  // of each row group, the one with a third m16 tile included)
  const int rg = warp / kRowGroups;  // sim: m16 tiles rg, rg + 4, rg + 8
  const int cg = warp % kRowGroups;  // sim: queries 8 cg .. 8 cg + 7
  const int mq = warp & 1;           // PV: queries 16 mq .. 16 mq + 15
  const int nd = warp >> 1;          // PV: head dims 8 nd .. 8 nd + 7
  const int nmt = Kp / 16;
  const int col = cg * 8 + 2 * t;    // sim: this lane's two queries
  const uint32_t seed_mix = mix32(seed);
  const bool even = (N & 1) == 0;    // float2 rows of attn stay aligned
  const int ntiles = (N + kTQ - 1) / kTQ;
  int buf = 0;
  for (int tile = split; tile < ntiles; tile += S, buf ^= 1) {
    const int n0 = tile * kTQ;
    cp_async_wait<0>();
    __syncthreads();  // this tile's q is in; the previous tile is done
    // the next tile's q loads into the other buffer while this one computes
    if (tile + S < ntiles) load_q(tile + S, buf ^ 1);

    // ---- sim = k q^T (3xTF32), then + bias, in the fragments ----------
    float acc[kMT][4];
    float accs[kMT][4];  // the small terms: a second chain of mma.sync
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = accs[i][e] = 0.0f;
    }
    const float* sq = s_q + buf * kTQ * ldq + (cg * 8 + g) * ldq + t;
    for (int d0 = 0; d0 < Dp; d0 += 8) {
      Split<2> b;
      b.set(0, sq[d0]);
      b.set(1, sq[d0 + 4]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int mt = rg + kRowGroups * i;
        if (mt < nmt) {
          const int r = (mt * 16 + g) * ldk + d0 + t;
          const int at[4] = {r, r + 8 * ldk, r + 4, r + 8 * ldk + 4};
          Split<4> a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a.hi[e] = s_khi[at[e]];
            a.lo[e] = s_klo[at[e]];
          }
          mma_3xtf32(acc[i], accs[i], a, b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += accs[i][e];
    }
    // this lane's two queries in a window: (qy, qx) at an offset of
    // qy * tn_cols + qx.  K1 blends a query's right tap column as the next
    // query's left one: the second query's left column is the first one's
    // right where both sit in one window row, and the lane 1 up (t + 1)
    // holds the next pair, whose left column is the second query's right
    // unless a window row ends there (or t = 3: the next pair is another
    // warp's); the lane blends those columns itself.
    int woff[2], qx1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = min(n0 + col + j, N - 1);
      const int qy = n / side;
      qx1 = n - qy * side;
      woff[j] = qy * tn_cols + qx1;
    }
    const bool in0 = n0 + col < N;
    const bool in1 = n0 + col + 1 < N;
    const bool adjacent = woff[1] == woff[0] + 1;
    const bool from_next = t < 3 && qx1 < side - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int mt = rg + kRowGroups * i;
      if (mt >= nmt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
        const int kk = mt * 16 + g + 8 * h;
        const int kc = min(kk, K - 1);  // every lane takes part in the shuffle
        const float fy = s_fy[kc];
        const float fx = s_fx[kc];
        const float gy = __fsub_rn(1.0f, fy);
        const float gx = __fsub_rn(1.0f, fx);
        const float* base = table + s_y0[kc] * tn_cols + s_x0[kc];
        // K1's y-blend of the tap column at window offset o, each op rounded
        auto yblend = [&](int o) {
          return __fadd_rn(__fmul_rn(base[o], gy), __fmul_rn(base[o + tn_cols], fy));
        };
        const float left0 = yblend(woff[0]);
        const float right0 = yblend(woff[0] + 1);
        const float next = __shfl_down_sync(0xffffffffu, left0, 1);
        const float l1 = adjacent ? right0 : yblend(woff[1]);
        const float right1 = from_next ? next : yblend(woff[1] + 1);
        if (kk >= K) {  // a padding row: no weight in the softmax
          acc[i][2 * h] = acc[i][2 * h + 1] = -INFINITY;
          continue;
        }
        if (in0) {
          acc[i][2 * h] = __fadd_rn(
              acc[i][2 * h], __fadd_rn(__fmul_rn(left0, gx), __fmul_rn(right0, fx)));
        }
        if (in1) {
          acc[i][2 * h + 1] = __fadd_rn(
              acc[i][2 * h + 1], __fadd_rn(__fmul_rn(l1, gx), __fmul_rn(right1, fx)));
        }
        mx[0] = fmaxf(mx[0], acc[i][2 * h]);
        mx[1] = fmaxf(mx[1], acc[i][2 * h + 1]);
      }
    }

    // ---- softmax over the kv rows of each query: the fragment's rows by
    // shuffles (a butterfly: every lane ends with the same bits), then the
    // four row groups in order ------------------------------------------
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
    }
    if (g == 0) {
      s_max[rg * kTQ + col] = mx[0];
      s_max[rg * kTQ + col + 1] = mx[1];
    }
    __syncthreads();
    float m[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[j] = fmaxf(fmaxf(s_max[col + j], s_max[kTQ + col + j]),
                   fmaxf(s_max[2 * kTQ + col + j], s_max[3 * kTQ + col + j]));
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (rg + kRowGroups * i >= nmt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][e] = expf(acc[i][e] - m[e & 1]);
        sum[e & 1] += acc[i][e];
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      sum[0] += __shfl_xor_sync(0xffffffffu, sum[0], off);
      sum[1] += __shfl_xor_sync(0xffffffffu, sum[1], off);
    }
    if (g == 0) {
      s_sum[rg * kTQ + col] = sum[0];
      s_sum[rg * kTQ + col + 1] = sum[1];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sum[j] = ((s_sum[col + j] + s_sum[kTQ + col + j]) +
                s_sum[2 * kTQ + col + j]) + s_sum[3 * kTQ + col + j];
    }

    // ---- p = e / sum (written out), drop(p) into shared memory ---------
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int mt = rg + kRowGroups * i;
      if (mt >= nmt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g + 8 * h;
        const int n = n0 + col;
        float p0 = acc[i][2 * h] / sum[0];
        float p1 = acc[i][2 * h + 1] / sum[1];
        if (kk < K) {
          const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
          if (even && n < N) {
            *reinterpret_cast<float2*>(attn + idx) = make_float2(p0, p1);
          } else {
            if (n < N) attn[idx] = p0;
            if (n + 1 < N) attn[idx + 1] = p1;
          }
          if (threshold != 0u) {
            p0 = dropout_keep(seed_mix, idx, threshold) ? p0 * scale : 0.0f;
            p1 = dropout_keep(seed_mix, idx + 1, threshold) ? p1 * scale : 0.0f;
          }
        }
        uint2 hi, lo;
        split_tf32(p0, hi.x, lo.x);
        split_tf32(p1, hi.y, lo.y);
        *reinterpret_cast<uint2*>(s_phi + kk * kLdp + col) = hi;
        *reinterpret_cast<uint2*>(s_plo + kk * kLdp + col) = lo;
      }
    }
    __syncthreads();

    // ---- out = drop(p)^T v (3xTF32): a 16 x 8 tile a warp ---------------
    if (nd * 8 < Dp) {
      // four chains of mma.sync: the even and odd k8 steps, each with its
      // small terms apart, added in a fixed order at the end
      float o[2][4], os[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[0][e] = o[1][e] = os[0][e] = os[1][e] = 0.0f;
      const int pr = t * kLdp + mq * 16 + g;
      const float* vr = s_v + t * ldv + nd * 8 + g;
      // (Kp is a multiple of 16: the k8 steps come in pairs)
      auto step = [&](int k0, float (&big)[4], float (&small)[4]) {
        const int r = pr + k0 * kLdp;
        const int at[4] = {r, r + 8, r + 4 * kLdp, r + 4 * kLdp + 8};
        Split<4> a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a.hi[e] = s_phi[at[e]];
          a.lo[e] = s_plo[at[e]];
        }
        Split<2> b;
        b.set(0, vr[k0 * ldv]);
        b.set(1, vr[(k0 + 4) * ldv]);
        mma_3xtf32(big, small, a, b);
      };
      for (int k0 = 0; k0 < Kp; k0 += 16) {
        step(k0, o[0], os[0]);
        step(k0 + 8, o[1], os[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[0][e] = (o[0][e] + os[0][e]) + (o[1][e] + os[1][e]);
      }
      const int d = nd * 8 + 2 * t;
      if (d < D) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + mq * 16 + g + 8 * h;
          if (n < N) {
            *reinterpret_cast<float2*>(out + (static_cast<size_t>(bh) * N + n) * D + d) =
                make_float2(o[0][2 * h], o[0][2 * h + 1]);
          }
        }
      }
    }
  }
}

}  // namespace

// Shared memory of one K6-fwd block, in bytes.
extern "C" int dmlt_fused_table_fwd_smem(int tn_rows, int tn_cols, int K,
                                         int D) {
  (void)tn_rows;  // the table is read through L1
  (void)tn_cols;
  return static_cast<int>(sizeof(float)) * fwd_smem_floats(K, D);
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
  // blocks per bh: a function of BH alone, at most one per query tile
  const int ntiles = (N + kTQ - 1) / kTQ;
  const int splits = max(1, min(kFwdBlocks / BH, ntiles));
  fused_table_fwd_kernel<<<dim3(splits, BH), kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table), tn_rows,
      tn_cols, static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<float*>(out), static_cast<float*>(attn), K, N, D, side,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(threshold), scale);
  return static_cast<int>(cudaGetLastError());
}
