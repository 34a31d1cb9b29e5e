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
// all f32-accurate; ds is written as [BH, K, N] in either layout.  c[n] is
// an exact f32 sum on the CUDA cores, not a product on the tensor cores:
// the softmax backward relies on sum_k ds[k, n] = 0, and the error of a
// rounded c accumulates in the bias parameters' cotangents (the note at
// deform_attn.py:2989-2993).
//
// What bounds it on the card.  Four K x N x D products per bh (dp, dv, dq,
// dk: 5.9 GFLOP at the teacher's shapes; three tensor-core passes each
// here, 17.7 GFLOP of TF32, 36 us at 495 TFLOP/s) against 158 MB of q, k,
// v, attn, g, ga, dq, dk, dv and ds (47 us at 3.35 TB/s), counted from the
// shapes: the bytes.
//
// What the design does about that, and why it is deterministic.  On the
// TPU's grid one step per bh works through all N queries; with one block
// per bh only 32 of the 132 SMs would work.  Here S blocks share each bh
// (S = the wrapper's fixed split, 4 at BH = 32, so 128 blocks fill the
// card), and each block walks its own fixed set of query tiles in order.
//
// K <= kMaxK = 160 (K6 always; K7 at the teacher's K = 144), the resident
// kernel: 16 warps, one block an SM (209 KB of shared memory at K = 144,
// D = 64), k and v staged once in shared memory, 32-query tiles of q and g
// double-buffered by cp.async.  The four products run on the tensor cores
// as 3xTF32 mma.sync (tf32_mma.cuh): dp = v g^T, with the map read from
// device memory straight into the fragment's registers (the next tile's
// map and its cotangent prefetched towards L1 meanwhile); then on the CUDA
// cores the mask (each element's hash once, its bit kept for drop(p)), ga,
// c (the fragment's rows by a shuffle butterfly, then the four row groups'
// partials in a fixed order) and ds = p (dp - c), written out and, with
// drop(p), split into TF32 hi and lo into shared memory, where several
// warps read them; then dv += drop(p) g and dk += ds q, held in registers
// over the block's tiles (a warp owns up to 3 x 2 tiles of 16 x 8; the
// four warps of a row group issue on the four schedulers), and dq = ds^T k
// (a warp 16 queries x 16 dims over half the kv rows, the two halves added
// in a fixed order after a barrier of the pair of warps), complete in the
// tile.  Each block writes its dk and dv as one partial, summed over the S
// blocks in block order (fixed_order_sum.cuh).  K is padded to 16 rows and
// D to 8 columns with zeros in shared memory, and the query tail is masked.
//
// K > kMaxK (K7 only: the 1-D attention's K = 625), the chunked kernel,
// f32 on the CUDA cores: 64-query tiles, k and v chunks from device memory
// for each tile, a first pass over the chunks computes dp and c and parks
// dp in ds, a second turns it into ds, and each tile adds its dk and dv of
// a chunk's rows into the block's partial in device memory (which only
// that block touches), in tile order.
//
// No atomics: two runs on the same inputs give bitwise-equal results.
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"
#include "fused_table.cuh"
#include "tf32_mma.cuh"

namespace {

__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBTQ = 32;          // queries of a resident tile
constexpr int kBRowGroups = 4;    // warps along the kv rows
constexpr int kBMT = (kMaxK / 16 + kBRowGroups - 1) / kBRowGroups;  // m16 tiles a warp
constexpr int kLdm = kBTQ + 4;    // row stride of drop(p) and ds [Kp, kBTQ]

__host__ __device__ inline int bwd_pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int bwd_pad8(int x) { return (x + 7) & ~7; }

// shared floats of a resident block: k and q rows 8 mod 32 banks apart, v
// and g rows 4 (the fragment reads of dq and dk, and of dp, conflict-free
// at D = 64)
__host__ __device__ inline int resident_smem_floats(int K, int D) {
  const int Kp = bwd_pad16(K);
  const int Dp = bwd_pad8(D);
  return Kp * (Dp + 8) + Kp * (Dp + 4) + 2 * kBTQ * (Dp + 8) +
         3 * kBTQ * (Dp + 4) + 4 * Kp * kLdm + kBRowGroups * kBTQ;
}

__global__ void __launch_bounds__(kBwdThreads, 1)
fused_attention_bwd_resident_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ attn,
    const float* __restrict__ gout, const float* __restrict__ gattn,
    float* __restrict__ dq, float* __restrict__ ds, float* __restrict__ partial,
    int BH, int K, int N, int D, int nk, uint32_t seed, uint32_t threshold,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int bh = blockIdx.y;
  const int Kp = bwd_pad16(K);
  const int Dp = bwd_pad8(D);
  const int ldk = Dp + 8;
  const int ldv = Dp + 4;
  const int ldq = Dp + 8;
  const int ldg = Dp + 4;
  float* s_k = smem;                    // [Kp, ldk]
  float* s_v = s_k + Kp * ldk;          // [Kp, ldv]
  float* s_q = s_v + Kp * ldv;          // [2, kBTQ, ldq] the q tiles
  float* s_g = s_q + 2 * kBTQ * ldq;    // [2, kBTQ, ldg] the g tiles
  // drop(p) and ds, split into TF32 hi and lo as they are written: each
  // value is read by several warps
  uint32_t* s_pd = reinterpret_cast<uint32_t*>(s_g + 2 * kBTQ * ldg);
  uint32_t* s_ds = s_pd + 2 * Kp * kLdm;  // [2, Kp, kLdm] each: hi, lo
  float* s_dqp = reinterpret_cast<float*>(s_ds + 2 * Kp * kLdm);  // [kBTQ, ldg]
  float* s_red = s_dqp + kBTQ * ldg;    // [kBRowGroups, kBTQ]
  const int lo = Kp * kLdm;  // from hi to lo

  const float* qb = q + static_cast<size_t>(bh) * N * D;
  const float* gb = gout + static_cast<size_t>(bh) * N * D;
  const int chunks = D / 4;  // 16-byte pieces of a row
  // the q and g tiles of `tile` into buffer buf, asynchronously, zeros
  // past N
  auto load_qg = [&](int tile, int buf) {
    const int n0 = tile * kBTQ;
    float* dq_ = s_q + buf * kBTQ * ldq;
    float* dg_ = s_g + buf * kBTQ * ldg;
    for (int i = threadIdx.x; i < kBTQ * chunks; i += kBwdThreads) {
      const int n = i / chunks;
      const int c = i - n * chunks;
      const bool in = n0 + n < N;
      const size_t off = static_cast<size_t>(in ? n0 + n : 0) * D + 4 * c;
      cp_async16(dq_ + n * ldq + 4 * c, qb + off, in);
      cp_async16(dg_ + n * ldg + 4 * c, gb + off, in);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragments' row group
  const int t = lane & 3;   // and the lane within it
  // (warp w issues on scheduler w % 4, so each scheduler takes one warp
  // of each row group, the one with a third m16 tile included)
  const int rg = warp / kBRowGroups;  // kv m16 tiles rg, rg + 4, rg + 8
  const int cg = warp % kBRowGroups;  // dp: queries 8 cg ..; dk, dv: dims 16 cg ..
  const int nmt = Kp / 16;
  const int col = cg * 8 + 2 * t;     // dp: this lane's two queries
  // the map and its cotangent at this lane's elements of `tile` towards
  // L1 (one prefetch a pair of queries): the loads of the dp phase then
  // wait on L1, not on device memory
  auto prefetch_map = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kBMT; ++i) {
      const int mt = rg + kBRowGroups * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g + 8 * h;
        const int n = tile * kBTQ + col;
        if (mt >= nmt || kk >= K || n >= N) continue;
        const size_t at = nk ? (static_cast<size_t>(bh) * N + n) * K + kk
                             : (static_cast<size_t>(bh) * K + kk) * N + n;
        prefetch_l1(attn + at);
        if (gattn != nullptr) prefetch_l1(gattn + at);
      }
    }
  };
  load_qg(split, 0);  // in flight while k and v are staged
  prefetch_map(split);

  const float* kb = k + static_cast<size_t>(bh) * K * D;
  const float* vb = v + static_cast<size_t>(bh) * K * D;
  for (int i = threadIdx.x; i < Kp * Dp; i += kBwdThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const bool in = r < K && d < D;
    s_k[r * ldk + d] = in ? kb[r * D + d] : 0.0f;
    s_v[r * ldv + d] = in ? vb[r * D + d] : 0.0f;
  }
  // the tiles' padding columns D .. Dp, which cp.async never writes
  for (int i = threadIdx.x; i < 2 * kBTQ * (Dp - D); i += kBwdThreads) {
    const int row = i / (Dp - D);
    const int d = D + i - row * (Dp - D);
    s_q[row * ldq + d] = 0.0f;
    s_g[row * ldg + d] = 0.0f;
  }

  const int mq = warp & 1;            // dq: queries 16 mq .. 16 mq + 15,
  const int np = (warp >> 1) & 3;     // head dims 16 np .. 16 np + 15,
  const int kh = warp >> 3;           // the first or second half of the kv rows
  const uint32_t seed_mix = mix32(seed);
  const bool even = (N & 1) == 0;     // float2 rows of ds stay aligned
  float acc_dk[kBMT][2][4];
  float acc_dv[kBMT][2][4];
#pragma unroll
  for (int i = 0; i < kBMT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dk[i][j][e] = acc_dv[i][j][e] = 0.0f;
    }
  }

  const int ntiles = (N + kBTQ - 1) / kBTQ;
  int buf = 0;
  for (int tile = split; tile < ntiles; tile += S, buf ^= 1) {
    const int n0 = tile * kBTQ;
    cp_async_wait<0>();
    __syncthreads();  // this tile's q and g are in; the previous tile is done
    // the next tile's q and g load into the other buffers while this one
    // computes
    if (tile + S < ntiles) load_qg(tile + S, buf ^ 1);
    const float* sq = s_q + buf * kBTQ * ldq;
    const float* sg = s_g + buf * kBTQ * ldg;

    // ---- dp = v g^T (3xTF32), p read into the fragment's registers ------
    float p[kBMT][4];
#pragma unroll
    for (int i = 0; i < kBMT; ++i) {
      const int mt = rg + kBRowGroups * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = mt * 16 + g + 8 * (e >> 1);
        const int n = n0 + col + (e & 1);
        const bool in = mt < nmt && kk < K && n < N;
        const size_t idx =
            nk ? (static_cast<size_t>(bh) * N + n) * K + kk
               : (static_cast<size_t>(bh) * K + kk) * N + n;
        p[i][e] = in ? attn[idx] : 0.0f;
      }
    }
    // the next tile's map and its cotangent towards L1 while this tile
    // computes (the first tile's went before k and v were staged)
    if (tile + S < ntiles) prefetch_map(tile + S);
    float acc[kBMT][4];
#pragma unroll
    for (int i = 0; i < kBMT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    const float* sgr = sg + (cg * 8 + g) * ldg + t;
    for (int d0 = 0; d0 < Dp; d0 += 8) {
      Split<2> b;
      b.set(0, sgr[d0]);
      b.set(1, sgr[d0 + 4]);
#pragma unroll
      for (int i = 0; i < kBMT; ++i) {
        const int mt = rg + kBRowGroups * i;
        if (mt < nmt) {
          const float* vr = s_v + (mt * 16 + g) * ldv + d0 + t;
          Split<4> a;
          a.set(0, vr[0]);
          a.set(1, vr[8 * ldv]);
          a.set(2, vr[4]);
          a.set(3, vr[8 * ldv + 4]);
          mma_3xtf32(acc[i], a, b);
        }
      }
    }

    // ---- the mask and ga; c = sum_k p dp, exact f32 in a fixed order ----
    // (each element's mask bit kept for drop(p) below)
    float csum[2] = {0.0f, 0.0f};
    uint32_t kept = 0u;
#pragma unroll
    for (int i = 0; i < kBMT; ++i) {
      const int mt = rg + kBRowGroups * i;
      if (mt >= nmt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = mt * 16 + g + 8 * (e >> 1);
        const int n = n0 + col + (e & 1);
        float dp = acc[i][e];
        if (kk < K && n < N) {
          const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
          if (threshold != 0u) {
            const bool keep = dropout_keep(seed_mix, idx, threshold);
            kept |= static_cast<uint32_t>(keep) << (4 * i + e);
            dp = keep ? dp * scale : 0.0f;
          }
          if (gattn != nullptr) {
            dp = gattn[nk ? (static_cast<size_t>(bh) * N + n) * K + kk : idx] + dp;
          }
        }
        acc[i][e] = dp;
        csum[e & 1] += p[i][e] * dp;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      csum[0] += __shfl_xor_sync(0xffffffffu, csum[0], off);
      csum[1] += __shfl_xor_sync(0xffffffffu, csum[1], off);
    }
    if (g == 0) {
      s_red[rg * kBTQ + col] = csum[0];
      s_red[rg * kBTQ + col + 1] = csum[1];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      csum[j] = ((s_red[col + j] + s_red[kBTQ + col + j]) +
                 s_red[2 * kBTQ + col + j]) + s_red[3 * kBTQ + col + j];
    }

    // ---- ds = p (dp - c) (written out), drop(p) and ds into shared ------
#pragma unroll
    for (int i = 0; i < kBMT; ++i) {
      const int mt = rg + kBRowGroups * i;
      if (mt >= nmt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g + 8 * h;
        const int n = n0 + col;
        const float ds0 = p[i][2 * h] * (acc[i][2 * h] - csum[0]);
        const float ds1 = p[i][2 * h + 1] * (acc[i][2 * h + 1] - csum[1]);
        float p0 = p[i][2 * h];
        float p1 = p[i][2 * h + 1];
        if (kk < K) {
          const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
          if (even && n < N) {
            *reinterpret_cast<float2*>(ds + idx) = make_float2(ds0, ds1);
          } else {
            if (n < N) ds[idx] = ds0;
            if (n + 1 < N) ds[idx + 1] = ds1;
          }
          if (threshold != 0u) {
            p0 = (kept >> (4 * i + 2 * h)) & 1u ? p0 * scale : 0.0f;
            p1 = (kept >> (4 * i + 2 * h + 1)) & 1u ? p1 * scale : 0.0f;
          }
        }
        const float vals[4] = {ds0, ds1, p0, p1};
        uint32_t hi[4], lw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(vals[e], hi[e], lw[e]);
        const int at = kk * kLdm + col;
        *reinterpret_cast<uint2*>(s_ds + at) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(s_ds + lo + at) = make_uint2(lw[0], lw[1]);
        *reinterpret_cast<uint2*>(s_pd + at) = make_uint2(hi[2], hi[3]);
        *reinterpret_cast<uint2*>(s_pd + lo + at) = make_uint2(lw[2], lw[3]);
      }
    }
    __syncthreads();

    // ---- dv += drop(p) g, dk += ds q (3xTF32, registers over the tiles) --
#pragma unroll
    for (int n8 = 0; n8 < kBTQ; n8 += 8) {
      Split<2> bg[2], bq[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = (2 * cg + j) * 8 + g;
        if (d - g < Dp) {
          bg[j].set(0, sg[(n8 + t) * ldg + d]);
          bg[j].set(1, sg[(n8 + t + 4) * ldg + d]);
          bq[j].set(0, sq[(n8 + t) * ldq + d]);
          bq[j].set(1, sq[(n8 + t + 4) * ldq + d]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBMT; ++i) {
        const int mt = rg + kBRowGroups * i;
        if (mt >= nmt) continue;
        const int r = (mt * 16 + g) * kLdm + n8 + t;
        const int at[4] = {r, r + 8 * kLdm, r + 4, r + 8 * kLdm + 4};
        Split<4> ap, as;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ap.hi[e] = s_pd[at[e]];
          ap.lo[e] = s_pd[lo + at[e]];
          as.hi[e] = s_ds[at[e]];
          as.lo[e] = s_ds[lo + at[e]];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if ((2 * cg + j) * 8 < Dp) {
            mma_3xtf32(acc_dv[i][j], ap, bg[j]);
            mma_3xtf32(acc_dk[i][j], as, bq[j]);
          }
        }
      }
    }

    // ---- dq = ds^T k (3xTF32): a warp takes 16 queries x 16 head dims
    // over half the kv rows (each ds value read by 4 warps, not 8); the two
    // warps of the halves meet at a pair barrier, and the first adds the
    // second's sums to its own and stores them --------------------------
    {
      float o[2][4], os[2][4];  // per n8 tile; the small terms apart
#pragma unroll
      for (int e = 0; e < 4; ++e) o[0][e] = o[1][e] = os[0][e] = os[1][e] = 0.0f;
      const int half = Kp / 2;  // a multiple of 8
      const int sr = t * kLdm + mq * 16 + g;
      for (int k0 = kh * half; k0 < (kh + 1) * half; k0 += 8) {
        const int r = sr + k0 * kLdm;
        const int at[4] = {r, r + 8, r + 4 * kLdm, r + 4 * kLdm + 8};
        Split<4> a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a.hi[e] = s_ds[at[e]];
          a.lo[e] = s_ds[lo + at[e]];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if ((2 * np + j) * 8 >= Dp) break;
          const float* kr = s_k + (k0 + t) * ldk + (2 * np + j) * 8 + g;
          Split<2> b;
          b.set(0, kr[0]);
          b.set(1, kr[4 * ldk]);
          mma_3xtf32(o[j], os[j], a, b);
        }
      }
      float* po = s_dqp + (mq * 16 + g) * ldg + np * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if ((2 * np + j) * 8 >= Dp) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 own = make_float2(o[j][2 * h] + os[j][2 * h],
                                         o[j][2 * h + 1] + os[j][2 * h + 1]);
          if (kh == 1) {
            *reinterpret_cast<float2*>(po + 8 * h * ldg + 8 * j) = own;
          }
          o[j][2 * h] = own.x;
          o[j][2 * h + 1] = own.y;
        }
      }
      pair_barrier(1 + (warp & 7));
      if (kh == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = (2 * np + j) * 8 + 2 * t;
          if (d >= D) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + mq * 16 + g + 8 * h;
            const float2 x =
                *reinterpret_cast<const float2*>(po + 8 * h * ldg + 8 * j);
            if (n < N) {
              *reinterpret_cast<float2*>(dq + (static_cast<size_t>(bh) * N + n) * D + d) =
                  make_float2(o[j][2 * h] + x.x, o[j][2 * h + 1] + x.y);
            }
          }
        }
      }
    }
  }

  // ---- this block's partial dk and dv, from the registers ---------------
  const size_t plane = static_cast<size_t>(BH) * K * D;
  float* pk = partial + (static_cast<size_t>(split) * 2) * plane +
              static_cast<size_t>(bh) * K * D;  // this block's dk partial
  float* pv = pk + plane;                       // and dv partial
#pragma unroll
  for (int i = 0; i < kBMT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = (2 * cg + j) * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = (rg + kBRowGroups * i) * 16 + g + 8 * h;
        if (kk < K && d < D) {
          *reinterpret_cast<float2*>(pk + kk * D + d) =
              make_float2(acc_dk[i][j][2 * h], acc_dk[i][j][2 * h + 1]);
          *reinterpret_cast<float2*>(pv + kk * D + d) =
              make_float2(acc_dv[i][j][2 * h], acc_dv[i][j][2 * h + 1]);
        }
      }
    }
  }
}

// K > kMaxK: the kv rows in chunks of kMaxK, on the CUDA cores
__global__ void __launch_bounds__(kThreads, 1)
fused_attention_bwd_chunked_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ attn,
    const float* __restrict__ gout, const float* __restrict__ gattn,
    float* __restrict__ dq, float* __restrict__ ds, float* __restrict__ partial,
    int BH, int K, int N, int D, int nk, uint32_t seed, uint32_t threshold,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int bh = blockIdx.y;
  const int ld = row_stride(D);
  const int kc = kMaxK;  // kv rows of a chunk
  const int nchunks = (K + kMaxK - 1) / kMaxK;
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
  float acc_dk[kRows][4];  // a tile's dk and dv of a chunk's rows
  float acc_dv[kRows][4];

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
      const int nrows = min(kMaxK, K - c0);
      __syncthreads();  // the previous chunk is done with s_v, s_p, s_ds
      load_rows(s_v, vb, c0, nrows);
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
        if (n0 + c < N) {
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
      const int nrows = min(kMaxK, K - c0);
      __syncthreads();  // the previous pass or chunk is done with them
      load_rows(s_k, kb, c0, nrows);
      load_map(n0, c0, nrows, false);
      __syncthreads();
      const int n = n0 + c;
      for (int kk = part; kk < nrows; kk += 4) {
        const size_t idx = (static_cast<size_t>(bh) * K + c0 + kk) * N + n;
        const float p = s_p[kk * kQT + c];
        const float dp = n < N ? ds[idx] : 0.0f;
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
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;
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
}

}  // namespace

namespace {

// Shared memory of one block of the kernel that takes K, in bytes.
inline int fused_attention_bwd_smem(int K, int D) {
  if (K <= kMaxK) {
    return static_cast<int>(sizeof(float)) * resident_smem_floats(K, D);
  }
  const int ld = row_stride(D);
  return static_cast<int>(sizeof(float)) *
         (2 * kMaxK * ld + 2 * kQT * ld + D * kQT + 2 * kMaxK * kQT + 4 * kQT);
}

// Launches the kernel and the block-order sum of its dk / dv partials on
// stream; returns cudaGetLastError().  q [BH, N, D] (pre-scaled), k, v
// [BH, K, D], attn and gattn (or null) [BH, K, N] ("kn") or [BH, N, K]
// ("nk"), gout [BH, N, D], all f32 -> dq [BH, N, D], dkv [2, BH, K, D] (dk,
// then dv) and ds [BH, K, N].  partial is scratch of splits * 2 * BH * K *
// D f32; split s of a bh takes the query tiles s, s + splits, ... (32
// queries a tile for K <= 160, 64 past it), so splits is at most the count
// of 64-query tiles.
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
  const bool resident = K <= kMaxK;
  const auto kernel = resident ? fused_attention_bwd_resident_kernel
                               : fused_attention_bwd_chunked_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, BH), resident ? kBwdThreads : kThreads, smem, s>>>(
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
