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
// entries), everything f32-accurate.  The bias never leaves the SM.
//
// What bounds it on the card: the MLP's f32 arithmetic.  It costs ~2.3 k
// flops per (n, k) point, 26 GFLOP at the teacher's shapes (BH = 32, K =
// 144, N = 2500, D = 64; 0.39 ms at 67 TFLOP/s), against 2 x 2 x 32 x 144
// x 2500 x 64 = 2.95 GFLOP of sim and PV (three tensor-core passes here,
// 8.8 GFLOP of TF32, 18 us at 495 TFLOP/s) and 89 MB of q, k, v, out and
// attn (27 us at 3.35 TB/s), counted from the shapes.  The MLP keeps the
// CUDA cores' issue slots busy, so everything else costs what its
// instructions cost.
//
// What the design does about that.  The TPU kernels run the MLP as MXU
// matmuls on relaid (T*K, HID) tiles and clamp tiles and K to the TPU's
// (8, 128) layout; none of that carries over.  Here the MLP stays f32 FMA
// on the CUDA cores, with K2-fwd's four points a thread (mlp_hidden_rows,
// mlp_out_rows: each float4 of w2 read from shared memory feeds 16 fmafs,
// and each point keeps the fmaf chain of the single-point functions, so
// the bias is bitwise K2's), and the rest is arranged to add few
// instructions to it:
// - a warp owns a group of 16 queries (two n8 tiles of mma.sync m16n8k8)
//   against every kv row of the block's bh; the four points of a lane's
//   sim fragment (kv rows g and g + 8 of an m16 tile, queries 2t and
//   2t + 1 of an n8 tile) are four points its MLP evaluates, and the bias
//   goes through a per-lane slot of shared memory (the MLP's 128 live
//   values and the sim fragments never share the registers);
// - sim = k q^T and out^T = v^T drop(p)^T run on the tensor cores as
//   3xTF32 mma.sync (tf32_mma.cuh: f32-accurate, the small terms first),
//   each operand split into TF32 hi and lo as it is read (tf32_rna: two
//   integer ops with cvt.rna.tf32.f32's bits); each split k or v fragment
//   feeds both n8 tiles; PV takes the head dims as the m16 side and the
//   queries as n8, so drop(p) goes from
//   the sim fragments to PV's B fragments by warp shuffles, with no shared
//   memory and no barrier; the softmax (per query: the lane's values, then
//   a shuffle butterfly over the 8 lanes of its column), the map store and
//   the dropout hash stay f32 on the CUDA cores;
// - 8 warps, one block an SM (the MLP needs up to 255 registers a
//   thread); a fixed number of blocks share a bh (a function of BH alone,
//   4 at BH = 32), each stages the weights, k, v and grid_kv once, and
//   each warp walks its own groups with no block barrier, the next group's
//   q loading by cp.async from the end of this group's sim on.
// K is padded to 16 rows and D to 8 columns (16 for PV's head dims) with
// zeros in shared memory, and the query tail is masked.  Any N and any K:
// with one chunk of at most kMaxK = 160 kv rows (the teacher's K = 144)
// everything stays on the SM; with more, the block's warps take a group
// each in step, a first pass over the chunks (k and grid_kv staged per
// chunk) keeps each query's running max and sum of exp and parks sim in
// the map's place in device memory, a second (v staged per chunk) reads
// it back, normalizes it, stores the map and accumulates PV.  No library
// call.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "cpb_exact.cuh"
#include "fused_table.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBlocks = 132;  // blocks over all bh: one an H100 SM
constexpr int kNTMax = 2;        // n8 tiles of a warp's group, at most
constexpr int kMT = kMaxK / 16;  // m16 tiles of kv rows in a chunk
constexpr unsigned kFull = 0xffffffffu;

// floats of the weights, rounded up so that what follows stays 16-byte
// aligned
constexpr int kMlpFloats = (mlp_floats(1) + 3) & ~3;

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }

// Row strides of k (and the q groups) and of v in shared memory: the
// fragment reads of a warp fall in 32 different banks at D = 64 and 16
// (k and q rows 4 or 20 mod 32 banks apart, v rows 8 or 24).
__host__ __device__ inline int ld_k(int D) { return pad8(D) + 4; }
__host__ __device__ inline int ld_v(int D) { return pad16(D) + 8; }

// a warp's own shared memory: its q group [8 kNTMax, ld_k] and its bias
// slots [kNTMax, kMT, 32] float4
__host__ __device__ inline int warp_floats(int D) {
  return 8 * kNTMax * ld_k(D) + 4 * 32 * kMT * kNTMax;
}

// shared memory of a block: the weights; k, v and grid_kv of one chunk
// of at most kMaxK kv rows (padded to 16); each warp's q group and bias
__host__ __device__ inline int fwd_smem_floats(int K, int D) {
  const int kc = pad16(K < kMaxK ? K : kMaxK);
  return kMlpFloats + kc * (ld_k(D) + ld_v(D) + 2) +
         kFwdWarps * warp_floats(D);
}

__device__ __forceinline__ float warp_max8(float x) {  // over a column's lanes
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum8(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// sim of the warp's 8 NT queries against the chunk's nrows kv rows in
// shared memory, in the fragments of mma.sync: P[nt][mt][e] is kv row
// 16 mt + g + 8 (e >> 1), query 8 nt + 2t + (e & 1) of the group (lane =
// 4 g + t); -inf past nrows.  gq[nt][c]: grid_q of the lane's queries.
template <int NT>
__device__ __forceinline__ void chunk_sim(const Mlp& m,
                                          const float* __restrict__ s_k,
                                          int ldk,
                                          const float* __restrict__ s_kv,
                                          const float* __restrict__ sq,
                                          int Dp, int nrows,
                                          const float2 (&gq)[NT][2],
                                          float4* s_b,
                                          float (&P)[NT][kMT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nmt = (nrows + 15) >> 4;
  // the bias: the four points of each sim fragment, 4 at a time
#pragma unroll 1
  for (int f = 0; f < NT * nmt; ++f) {
    const int nt = f < nmt ? 0 : NT - 1;
    const int mt = f - nt * nmt;
    const float* kv0 = s_kv + 2 * min(mt * 16 + g, nrows - 1);
    const float* kv1 = s_kv + 2 * min(mt * 16 + g + 8, nrows - 1);
    const float2 ga = nt ? gq[NT - 1][0] : gq[0][0];
    const float2 gb = nt ? gq[NT - 1][1] : gq[0][1];
    const float fx[4] = {signed_log1p(ga.x - kv0[0]),
                         signed_log1p(gb.x - kv0[0]),
                         signed_log1p(ga.x - kv1[0]),
                         signed_log1p(gb.x - kv1[0])};
    const float fy[4] = {signed_log1p(ga.y - kv0[1]),
                         signed_log1p(gb.y - kv0[1]),
                         signed_log1p(ga.y - kv1[1]),
                         signed_log1p(gb.y - kv1[1])};
    float h2[4][kHid];
    mlp_hidden_rows<4>(m, fx, fy, h2);
    float b[4];
    mlp_out_rows<4>(m, h2, 0, 1, b);
    s_b[(nt * kMT + mt) * 32 + lane] = make_float4(b[0], b[1], b[2], b[3]);
  }
  // k q^T (3xTF32): A = k rows (m16), B = the group's q^T (NT n8 tiles),
  // each split A fragment feeding every n8 tile
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) P[nt][mt][e] = 0.0f;
    }
  }
  for (int d0 = 0; d0 < Dp; d0 += 8) {
    Split<2> b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt].set(0, sq[(8 * nt + g) * ldk + d0 + t]);
      b[nt].set(1, sq[(8 * nt + g) * ldk + d0 + t + 4]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt < nmt) {
        const float* a = s_k + (mt * 16 + g) * ldk + d0 + t;
        Split<4> A;
        A.set(0, a[0]);
        A.set(1, a[8 * ldk]);
        A.set(2, a[4]);
        A.set(3, a[8 * ldk + 4]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_3xtf32(P[nt][mt], A, b[nt]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float4 bias = s_b[(nt * kMT + min(mt, nmt - 1)) * 32 + lane];
      const float bb[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        P[nt][mt][e] = mt * 16 + g + 8 * (e >> 1) < nrows
                           ? P[nt][mt][e] + bb[e]
                           : -INFINITY;
      }
    }
  }
}

// The map before dropout (p, in the fragments) of the chunk's rows from
// c0 into attn in the asked layout, then P = drop(p): rows past nrows and
// queries past N store nothing, padded rows become 0.
template <int NT>
__device__ __forceinline__ void store_map_and_drop(
    float (&P)[NT][kMT][4], float* __restrict__ attn, int nk, int bh,
    int c0, int nrows, int n0, int K, int N, uint32_t seed_mix,
    uint32_t inner0, uint32_t threshold, float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bool even = (N & 1) == 0;  // float2 rows of "kn" stay aligned
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + 8 * nt + 2 * (lane & 3);  // the lane's first query
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        float& p0 = P[nt][mt][2 * h];
        float& p1 = P[nt][mt][2 * h + 1];
        if (row >= nrows) {
          p0 = p1 = 0.0f;
          continue;
        }
        const int kk = c0 + row;
        const size_t idx = (static_cast<size_t>(bh) * K + kk) * N + n;
        if (nk) {
          const size_t at = (static_cast<size_t>(bh) * N + n) * K + kk;
          if (n < N) attn[at] = p0;
          if (n + 1 < N) attn[at + K] = p1;
        } else if (even && n < N) {
          *reinterpret_cast<float2*>(attn + idx) = make_float2(p0, p1);
        } else {
          if (n < N) attn[idx] = p0;
          if (n + 1 < N) attn[idx + 1] = p1;
        }
        if (threshold != 0u) {
          p0 = dropout_keep(seed_mix, inner0, idx, threshold) ? p0 * scale
                                                              : 0.0f;
          p1 = dropout_keep(seed_mix, inner0, idx + 1, threshold)
                   ? p1 * scale
                   : 0.0f;
        }
      }
    }
  }
}

// o += v^T drop(p)^T of the chunk (3xTF32): A = v^T (the head dims, m16
// tiles of the ndt = pad16(D) / 16), B = drop(p) of each n8 tile of the
// warp's queries, the kv rows as k8 steps; each split A fragment feeds
// every n8 tile.  B's element (kv row k0 + t, query g) is P[nt][mt][2h +
// (g & 1)] of lane 4t + (g >> 1) (k0 = 16 mt + 8 h), and (k0 + t + 4, g)
// that of lane 16 + 4t + (g >> 1).
template <int NT>
__device__ __forceinline__ void chunk_pv(const float (&P)[NT][kMT][4],
                                         const float* __restrict__ s_v,
                                         int ldv, int ndt, int nrows,
                                         float (&o)[NT][4][4],
                                         float (&os)[NT][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nmt = (nrows + 15) >> 4;
  const int src = 4 * t + (g >> 1);
  const bool odd = g & 1;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (mt < nmt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Split<2> b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float e0 = __shfl_sync(kFull, P[nt][mt][2 * h], src);
          const float o0 = __shfl_sync(kFull, P[nt][mt][2 * h + 1], src);
          const float e1 = __shfl_sync(kFull, P[nt][mt][2 * h], src + 16);
          const float o1 = __shfl_sync(kFull, P[nt][mt][2 * h + 1], src + 16);
          b[nt].set(0, odd ? o0 : e0);
          b[nt].set(1, odd ? o1 : e1);
        }
        const float* vr = s_v + (mt * 16 + 8 * h + t) * ldv + g;
#pragma unroll
        for (int dt = 0; dt < 4; ++dt) {
          if (dt < ndt) {
            Split<4> A;
            A.set(0, vr[16 * dt]);
            A.set(1, vr[16 * dt + 8]);
            A.set(2, vr[4 * ldv + 16 * dt]);
            A.set(3, vr[4 * ldv + 16 * dt + 8]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_3xtf32(o[nt][dt], os[nt][dt], A, b[nt]);
            }
          }
        }
      }
    }
  }
}

// kResident: K <= kMaxK, one chunk of kv rows staged once (the map never
// leaves the SM); otherwise K > kMaxK in chunks of kMaxK
template <bool kResident>
__global__ void __launch_bounds__(kFwdThreads, 1)
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
  // n8 tiles of a warp's group: two with one chunk (each split k or v
  // fragment feeds both), one in kv chunks (where the block's warps step
  // together, smaller groups leave fewer warps idle in the last step)
  constexpr int kNT = kResident ? kNTMax : 1;
  constexpr int kGroup = 8 * kNT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.y;
  const int Dp = pad8(D);
  const int ndt = pad16(D) / 16;
  const int ldk = ld_k(D);
  const int ldv = ld_v(D);
  const int kc = kResident ? pad16(K) : kMaxK;  // rows of the chunk buffers
  const int nchunks = kResident ? 1 : (K + kMaxK - 1) / kMaxK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, b3, 1);
  float* s_k = smem + kMlpFloats;  // [kc, ldk]
  float* s_v = s_k + kc * ldk;     // [kc, ldv]
  float* s_kv = s_v + kc * ldv;    // [kc, 2]
  float* s_q = s_kv + 2 * kc + warp * warp_floats(D);  // [kGroup, ldk]
  float4* s_b = reinterpret_cast<float4*>(s_q + 8 * kNTMax * ldk);

  // rows c0 .. c0 + nrows of k and grid_kv (with_k) or v into the chunk
  // buffers, zeros past them and in the padding columns
  auto stage = [&](int c0, int nrows, bool with_k) {
    const int w = with_k ? Dp : pad16(D);
    for (int i = threadIdx.x; i < kc * w; i += kFwdThreads) {
      const int r = i / w;
      const int d = i - r * w;
      const size_t at = (static_cast<size_t>(bh) * K + c0 + r) * D + d;
      const bool in = r < nrows && d < D;
      if (with_k) {
        s_k[r * ldk + d] = in ? k[at] : 0.0f;
      } else {
        s_v[r * ldv + d] = in ? v[at] : 0.0f;
      }
    }
    if (with_k) {
      for (int i = threadIdx.x; i < 2 * kc; i += kFwdThreads) {
        s_kv[i] = i < 2 * nrows
                      ? grid_kv[(static_cast<size_t>(bh) * K + c0) * 2 + i]
                      : 0.0f;
      }
    }
  };
  // the q rows of group grp into the warp's buffer, asynchronously, zeros
  // past N (the padding columns D .. Dp are zeroed once below)
  const int pieces = D / 4;  // 16-byte pieces of a q row
  auto load_q = [&](int grp) {
    const int n0 = grp * kGroup;
    for (int i = lane; i < kGroup * pieces; i += 32) {
      const int n = i / pieces;
      const int c = i - n * pieces;
      const bool in = n0 + n < N;
      cp_async16(s_q + n * ldk + 4 * c,
                 q + (static_cast<size_t>(bh) * N + (in ? n0 + n : 0)) * D +
                     4 * c,
                 in);
    }
    cp_async_commit();
  };
  for (int i = lane; i < kGroup * (Dp - D); i += 32) {
    const int row = i / (Dp - D);
    s_q[row * ldk + D + i - row * (Dp - D)] = 0.0f;
  }

  const int ngroups = (N + kGroup - 1) / kGroup;
  const int stride = gridDim.x * kFwdWarps;  // groups the block's warps skip
  const int first = blockIdx.x * kFwdWarps + warp;
  const uint32_t seed_mix = mix32(seed);
  const uint32_t inner0 = mix32(seed_mix);
  // grid_q of the lane's four queries (clamped past N)
  auto lane_grid = [&](int n0, float2 (&gq)[kNT][2]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gq[nt][c] = reinterpret_cast<const float2*>(grid_q)[min(
            n0 + 8 * nt + 2 * t + c, N - 1)];
      }
    }
  };
  auto store_out = [&](int n0, const float (&o)[kNT][4][4]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * dt + g + 8 * (e >> 1);
          const int n = n0 + 8 * nt + 2 * t + (e & 1);
          if (dt < ndt && d < D && n < N) {
            out[(static_cast<size_t>(bh) * N + n) * D + d] = o[nt][dt][e];
          }
        }
      }
    }
  };
  auto zero = [](float (&o)[kNT][4][4]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][dt][e] = 0.0f;
      }
    }
  };
  auto add = [](float (&o)[kNT][4][4], const float (&os)[kNT][4][4]) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][dt][e] += os[nt][dt][e];
      }
    }
  };

  if (kResident) {
    stage(0, K, true);
    stage(0, K, false);
    __syncthreads();  // the weights, k, v and grid_kv are in
    if (first < ngroups) load_q(first);
    for (int grp = first; grp < ngroups; grp += stride) {
      const int n0 = grp * kGroup;
      float2 gq[kNT][2];
      lane_grid(n0, gq);
      cp_async_wait<0>();
      __syncwarp();  // this group's q is in
      float P[kNT][kMT][4];
      chunk_sim(m, s_k, ldk, s_kv, s_q, Dp, K, gq, s_b, P);
      __syncwarp();  // every lane is done with this group's q
      if (grp + stride < ngroups) load_q(grp + stride);
      // softmax over the kv rows of each of the lane's four queries
      float mx[kNT][2];
      float sum[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mx[nt][0] = mx[nt][1] = -INFINITY;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mx[nt][e & 1] = fmaxf(mx[nt][e & 1], P[nt][mt][e]);
          }
        }
        mx[nt][0] = warp_max8(mx[nt][0]);
        mx[nt][1] = warp_max8(mx[nt][1]);
        sum[nt][0] = sum[nt][1] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (mt * 16 < K) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              P[nt][mt][e] = expf(P[nt][mt][e] - mx[nt][e & 1]);
              sum[nt][e & 1] += P[nt][mt][e];
            }
          }
        }
        sum[nt][0] = warp_sum8(sum[nt][0]);
        sum[nt][1] = warp_sum8(sum[nt][1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) P[nt][mt][e] /= sum[nt][e & 1];
        }
      }
      store_map_and_drop(P, attn, nk, bh, 0, K, n0, K, N, seed_mix, inner0,
                         threshold, scale);
      float o[kNT][4][4];
      float os[kNT][4][4];
      zero(o);
      zero(os);
      chunk_pv(P, s_v, ldv, ndt, K, o, os);
      add(o, os);
      store_out(n0, o);
    }
    return;
  }

  // K > kMaxK: the block's warps take a group each in step, the chunks
  // staged for all of them
  const int steps = (ngroups + stride - 1) / stride;
  for (int st = 0; st < steps; ++st) {
    const int grp = first + st * stride;
    const bool active = grp < ngroups;
    const int n0 = grp * kGroup;
    if (active) load_q(grp);
    float2 gq[kNT][2];
    lane_grid(n0, gq);
    float row_max[kNT][2];
    float row_sum[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      row_max[nt][0] = row_max[nt][1] = -INFINITY;
      row_sum[nt][0] = row_sum[nt][1] = 0.0f;
    }
    // pass 1: sim of each chunk, the running max and sum of exp; sim
    // parked in the map's place
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * kMaxK;
      const int nrows = min(kMaxK, K - c0);
      __syncthreads();  // every warp is done with the previous chunk
      stage(c0, nrows, true);
      __syncthreads();
      if (!active) continue;
      cp_async_wait<0>();
      __syncwarp();
      float P[kNT][kMT][4];
      chunk_sim(m, s_k, ldk, s_kv, s_q, Dp, nrows, gq, s_b, P);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float mx[2] = {row_max[nt][0], row_max[nt][1]};
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mx[e & 1] = fmaxf(mx[e & 1], P[nt][mt][e]);
          }
        }
        mx[0] = warp_max8(mx[0]);
        mx[1] = warp_max8(mx[1]);
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[e & 1] += expf(P[nt][mt][e] - mx[e & 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          row_sum[nt][j] = row_sum[nt][j] * expf(row_max[nt][j] - mx[j]) +
                           warp_sum8(sum[j]);
          row_max[nt][j] = mx[j];
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + 8 * (e >> 1);
            const int n = n0 + 8 * nt + 2 * t + (e & 1);
            if (row < nrows && n < N) {
              const int kk = c0 + row;
              attn[nk ? (static_cast<size_t>(bh) * N + n) * K + kk
                      : (static_cast<size_t>(bh) * K + kk) * N + n] =
                  P[nt][mt][e];
            }
          }
        }
      }
    }
    // pass 2: p = exp(sim - max) / sum, the map, the dropout, PV
    float o[kNT][4][4];
    float os[kNT][4][4];
    zero(o);
    zero(os);
    for (int ci = 0; ci < nchunks; ++ci) {
      const int c0 = ci * kMaxK;
      const int nrows = min(kMaxK, K - c0);
      __syncthreads();
      stage(c0, nrows, false);
      __syncthreads();
      if (!active) continue;
      float P[kNT][kMT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + 8 * (e >> 1);
            const int n = n0 + 8 * nt + 2 * t + (e & 1);
            const int kk = c0 + row;
            P[nt][mt][e] =
                (row < nrows && n < N)
                    ? expf(attn[nk ? (static_cast<size_t>(bh) * N + n) * K + kk
                                   : (static_cast<size_t>(bh) * K + kk) * N +
                                         n] -
                           row_max[nt][e & 1]) /
                          row_sum[nt][e & 1]
                    : 0.0f;
          }
        }
      }
      store_map_and_drop(P, attn, nk, bh, c0, nrows, n0, K, N, seed_mix,
                         inner0, threshold, scale);
      chunk_pv(P, s_v, ldv, ndt, nrows, o, os);
    }
    add(o, os);
    if (active) store_out(n0, o);
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
  // blocks per bh: a function of BH alone, at most one per 8 warps' groups
  const int group = 8 * (K <= kMaxK ? kNTMax : 1);  // queries of a group
  const int ngroups = (N + group - 1) / group;
  const int splits = max(1, min(kFwdBlocks / BH,
                                (ngroups + kFwdWarps - 1) / kFwdWarps));
  kernel<<<dim3(splits, BH), kFwdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
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
