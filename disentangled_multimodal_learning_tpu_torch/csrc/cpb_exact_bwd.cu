// K2-bwd: gradient of the exact continuous-position-bias (CPB) MLP, for a
// bias cotangent in the "kn" or the "nk" layout.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _cpbt_bwd_kernel (the TPU kernel behind the custom VJP of
// cpb_bias_transposed, _cpbt_vjp_bwd) and, in "nk", the backward kernels
// of the four layouts of the same function: v1 _cpb_wide_bwd_kernel, v5
// _cpb5_bwd_kernel, v2 _cpb_flat_bwd_kernel and wide4 _w4_bwd_kernel.
//
// What it computes: with the forward of cpb_exact.cu at every kv row
// r = bh * K + k and query n (p = grid_q[n] - grid_kv[r], f = sign(p) *
// log1p|p|, z1 = f @ w1 + b1, h1 = relu(z1), z2 = h1 @ w2 + b2,
// h2 = relu(z2)) and the bias cotangent db[o] = dbias[bh, o, k, n] ("kn")
// or dbias[bh, o, n, k] ("nk"):
//     dz2 = (w3 @ db) * (z2 > 0)        dz1 = (w2 @ dz2) * (z1 > 0)
//     dW3 += h2 db^T   db3 += db        dW2 += h1 dz2^T   db2 += dz2
//     dW1 += f dz1^T   db1 += dz1
//     dgrid_kv[r] = -sum_n (w1 @ dz1) / (1 + |p|)
// summed over all BH * K * N points (11.5 M at production shapes).  grid_q
// gets no cotangent (it is a constant grid).  d/dp of sign(p) log1p|p| is
// taken as 1 / (1 + |p|), also at p = 0, as in the TPU kernel.
//
// What bounds it on the card: f32 arithmetic.  Per point the kernel
// recomputes the forward (~1.1 k fmafs), runs the backward (dz2, dz1 and
// the kv coordinates' cotangent, ~1.1 k) and adds the point's outer
// products to the parameter gradients (dW2 alone 1,024 fmafs): ~75 GFLOP
// per call at production shapes (BH = 32, K = 144, N = 2500; 1.12 ms at 67
// TFLOP/s, counted from the shapes), while it reads only the 46 MB bias
// cotangent.  Three products per tile of P points carry nearly all of it:
// Z2 = H1 W2, dZ1 = dZ2 W2^T and dW2 += H1^T dZ2 (P x 32 by 32 x 32 or
// 32 x P by P x 32).  Written point by point, each fmaf takes one operand
// from shared memory (a w2 broadcast per 4 fmafs at best, two scalar loads
// per fmaf for the gradient sums), and the shared-memory pipe, which
// issues about a quarter of the fmaf rate, sets the pace.
//
// What the design does about that, and why it is deterministic: f32
// atomics would make every training step non-reproducible, so each block
// (128 threads) takes a fixed run of whole kv rows, in tiles of 128
// queries, and writes its partial gradients to device memory; a second
// kernel sums the partials in block order.  Per tile, with the weights in
// shared memory and the tile's activations point-major there (h1, h2,
// dz2, dz1: float4 chunks of four hidden units, each chunk a run of the
// 128 points, so a warp's 32 points are one 512-byte run; the chunks are
// padded by one float4 so that the 4-8 chunks a warp reads at one point
// fall in distinct banks):
//   1a. each thread forms its point's f and h1 (the forward's expression);
//   1b. Z2 = H1 W2 as a register-tiled product: a thread owns 4 points x 8
//       hidden units (its warp's 8 units, its lane's 4 points), so per 4
//       input units it reads 4 float4 of h1 and 8 float4 of w2 (warp
//       broadcasts) for 128 fmafs; then h2 = relu(z2 + b2) and dz2 =
//       (w3 @ db) * (z2 > 0);
//   1c. dZ1 = dZ2 W2^T the same way (4 float4 of dz2 and 8 of w2's rows
//       per 4 units of dz2), masked by h1 > 0;
//   1d. each thread sums its point's kv-coordinate cotangent from dz1;
//   2.  the tile's outer products: two groups of 64 threads take half the
//       points each; a thread owns a 4 x 4 register tile of dW2 and per
//       point reads one float4 of h1 and one of dz2 for 16 fmafs.  The
//       first warp of a group also owns a row of 4 of [db2; db1; dW1[0];
//       dW1[1]] (dz2 or dz1 against 1, fx or fy), the second dW3[j, :] for
//       its j and db3[lane], [lane + 32].
// Every hidden unit's fmaf chain runs over the input units in order, as in
// the single-point functions of cpb_exact.cuh.  At the end the second
// group's sums are added to the first's, in that order.  So every entry is
// summed over the block's points in a fixed order, and a row's dgrid_kv
// is a fixed-order block sum (warp shuffles, then the warps in order): two
// runs on the same inputs give bitwise-equal results.  Three blocks fit
// an SM at O <= 2 (72,368 and 73,008 bytes of shared memory a block).  The layout changes
// only where a point's cotangent is read, so "nk" gives the same gradients
// as "kn" on the transposed cotangent, bitwise (its loads are K floats
// apart across a warp; the kernel is bound by its arithmetic, not by these
// 46 MB).

#include <cuda_runtime.h>

#include "cpb_exact.cuh"
#include "fixed_order_sum.cuh"

namespace {

constexpr int kThreads = 128;  // = points per tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 64;     // threads of a group in the gradient sums
constexpr int kCs = 4 * kThreads + 4;  // floats of a tile's padded chunk
constexpr int kTile = (kHid / 4) * kCs;
// parameter-gradient entries: dW1 2*HID, db1 HID, dW2 HID*HID, db2 HID,
// dW3 HID*O, db3 O; their offsets in a block's partial
constexpr int kOffB1 = 2 * kHid;
constexpr int kOffW2 = kOffB1 + kHid;
constexpr int kOffB2 = kOffW2 + kHid * kHid;
constexpr int kOffW3 = kOffB2 + kHid;
static_assert(kWarps * 8 == kHid, "1b and 1c give each warp 8 hidden units");

// the weights' floats, rounded up so that the tiles stay 16-byte aligned
__host__ __device__ constexpr int weight_floats(int O) {
  return (mlp_floats(O) + 3) & ~3;
}
// shared floats: weights, h1/h2/dz2/dz1 tiles, f, db, block_sum scratch
__host__ __device__ constexpr int smem_floats(int O) {
  return weight_floats(O) + 4 * kTile + kThreads * (2 + O) + 2 * kWarps;
}

__host__ __device__ constexpr int num_params(int O) {
  return kOffW3 + (kHid + 1) * O;
}

// float index of hidden units 4c .. 4c + 3 of point p in a tile
__device__ __forceinline__ int at(int c, int p) { return c * kCs + 4 * p; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// kO = O for the shapes the models run (1, 2); 0 = any O up to kMaxOut
template <int kO>
__global__ void __launch_bounds__(kThreads, kO ? 3 : 2)
cpb_exact_bwd_partial_kernel(const float* __restrict__ grid_q,
                             const float* __restrict__ grid_kv,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             const float* __restrict__ w3,
                             const float* __restrict__ dbias,
                             float* __restrict__ dgrid_kv,
                             float* __restrict__ partial, int rows, int K,
                             int N, int o_arg, int rows_per_block, int nk) {
  constexpr int kOwn3 = kO ? kO : kMaxOut;  // dW3 entries a thread may own
  const int O = kO ? kO : o_arg;
  extern __shared__ __align__(16) float smem[];
  // the weights (b3 unused: it does not enter the gradient)
  const Mlp m = load_mlp(smem, w1, b1, w2, b2, w3, nullptr, O);
  float* s_h1 = smem + weight_floats(O);
  float* s_h2 = s_h1 + kTile;
  float* s_dz2 = s_h2 + kTile;
  float* s_dz1 = s_dz2 + kTile;
  float* s_f = s_dz1 + kTile;          // [kThreads][2]
  float* s_db = s_f + 2 * kThreads;    // [kThreads][O]
  float* s_red = s_db + kThreads * O;  // [2 * kWarps]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // phase 2 roles: group g sums points [g * 64, g * 64 + 64) of a tile
  const int g = t / kGroup;
  const int wg = warp % 2;           // warp within the group
  const int ib = wg * 4 + lane / 8;  // dW2 rows 4 ib .. 4 ib + 3
  const int jb = lane % 8;           // dW2 cols 4 jb .. 4 jb + 3
  const int q = lane / 8;  // first warp: 0 db2, 1 db1, 2 dW1[0], 3 dW1[1]
  const float* pa = s_h1 + ib * kCs;
  const float* pb = s_dz2 + jb * kCs;
  const float* pv = (q == 0 ? s_dz2 : s_dz1) + jb * kCs;
  const float* pu = s_f + q - 2;
  const float* ph = s_h2 + (lane >> 2) * kCs + (lane & 3);
  float acc[4][4];
  float acc_s[4];
  float acc3[kOwn3];
  float acc_b3[2];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    acc_s[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
#pragma unroll
  for (int o = 0; o < kOwn3; ++o) acc3[o] = 0.0f;
  acc_b3[0] = acc_b3[1] = 0.0f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const int bh = r / K;
    const int kk = r - bh * K;
    const float kx = grid_kv[2 * r];
    const float ky = grid_kv[2 * r + 1];
    float gx = 0.0f;
    float gy = 0.0f;
    for (int n0 = 0; n0 < N; n0 += kThreads) {
      __syncthreads();  // weights loaded; the previous tile is consumed
      // ---- 1a. f and h1 of point t (rows past N are never read) ---------
      const int n = n0 + t;
      const bool live = n < N;
      float px = 0.0f;
      float py = 0.0f;
      if (live) {
        px = grid_q[2 * n] - kx;
        py = grid_q[2 * n + 1] - ky;
        const float fx = signed_log1p(px);
        const float fy = signed_log1p(py);
        *reinterpret_cast<float2*>(s_f + 2 * t) = make_float2(fx, fy);
        for (int o = 0; o < O; ++o) {
          const size_t plane = static_cast<size_t>(bh * O + o) * K * N;
          s_db[t * O + o] = dbias[plane + (nk ? static_cast<size_t>(n) * K + kk
                                              : static_cast<size_t>(kk) * N + n)];
        }
#pragma unroll
        for (int c = 0; c < kHid / 4; ++c) {
          const float4 wa = ld4(m.w1 + 4 * c);
          const float4 wb = ld4(m.w1 + kHid + 4 * c);
          const float4 bb = ld4(m.b1 + 4 * c);
          float h1[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            h1[u] = fmaxf(fmaf(fx, comp(wa, u), fy * comp(wb, u)) + comp(bb, u),
                          0.0f);
          }
          st4(s_h1 + at(c, t), h1);
        }
      }
      __syncthreads();

      // ---- 1b. Z2 = H1 W2: points lane + 32 k, units 8 warp .. + 7 -------
      {
        float z[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int x = 0; x < 8; ++x) z[k][x] = 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kHid / 4; ++c) {
          float4 h[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) h[k] = ld4(s_h1 + at(c, lane + 32 * k));
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* wrow = m.w2 + (4 * c + u) * kHid + 8 * warp;
            const float4 lo = ld4(wrow);
            const float4 hi = ld4(wrow + 4);
            const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float hv = comp(h[k], u);
#pragma unroll
              for (int x = 0; x < 8; ++x) z[k][x] = fmaf(hv, wv[x], z[k][x]);
            }
          }
        }
        const float4 blo = ld4(m.b2 + 8 * warp);
        const float4 bhi = ld4(m.b2 + 8 * warp + 4);
        const float bv[8] = {blo.x, blo.y, blo.z, blo.w, bhi.x, bhi.y, bhi.z, bhi.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
          float h2[8];
          float dz2[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            h2[x] = fmaxf(z[k][x] + bv[x], 0.0f);
            dz2[x] = 0.0f;
          }
          for (int o = 0; o < O; ++o) {
            const float d = s_db[p * O + o];
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              dz2[x] = fmaf(m.w3[(8 * warp + x) * O + o], d, dz2[x]);
            }
          }
#pragma unroll
          for (int x = 0; x < 8; ++x) dz2[x] = (h2[x] > 0.0f) ? dz2[x] : 0.0f;
          st4(s_h2 + at(2 * warp, p), h2);
          st4(s_h2 + at(2 * warp + 1, p), h2 + 4);
          st4(s_dz2 + at(2 * warp, p), dz2);
          st4(s_dz2 + at(2 * warp + 1, p), dz2 + 4);
        }
      }
      __syncthreads();

      // ---- 1c. dZ1 = dZ2 W2^T, masked by h1 > 0 -------------------------
      {
        float d1[4][8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int x = 0; x < 8; ++x) d1[k][x] = 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kHid / 4; ++c) {
          float4 gz[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) gz[k] = ld4(s_dz2 + at(c, lane + 32 * k));
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float4 wv = ld4(m.w2 + (8 * warp + x) * kHid + 4 * c);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              d1[k][x] = fmaf(wv.x, gz[k].x, d1[k][x]);
              d1[k][x] = fmaf(wv.y, gz[k].y, d1[k][x]);
              d1[k][x] = fmaf(wv.z, gz[k].z, d1[k][x]);
              d1[k][x] = fmaf(wv.w, gz[k].w, d1[k][x]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float4 h1 = ld4(s_h1 + at(2 * warp + hh, p));
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              v[u] = (comp(h1, u) > 0.0f) ? d1[k][4 * hh + u] : 0.0f;
            }
            st4(s_dz1 + at(2 * warp + hh, p), v);
          }
        }
      }
      __syncthreads();

      // ---- 1d. the kv coordinates' cotangent of point t -----------------
      if (live) {
        float dfx = 0.0f;
        float dfy = 0.0f;
#pragma unroll
        for (int c = 0; c < kHid / 4; ++c) {
          const float4 v = ld4(s_dz1 + at(c, t));
          const float4 wa = ld4(m.w1 + 4 * c);
          const float4 wb = ld4(m.w1 + kHid + 4 * c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dfx = fmaf(comp(wa, u), comp(v, u), dfx);
            dfy = fmaf(comp(wb, u), comp(v, u), dfy);
          }
        }
        gx -= dfx / (1.0f + fabsf(px));
        gy -= dfy / (1.0f + fabsf(py));
      }

      // ---- 2. the tile's outer products, register-tiled ----------------
      const int p1 = min(N - n0, (g + 1) * (kThreads / 2));
#pragma unroll 4
      for (int p = g * (kThreads / 2); p < p1; ++p) {
        const float4 a = ld4(pa + 4 * p);
        const float4 b = ld4(pb + 4 * p);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
        }
        if (wg == 0) {  // [db2; db1; dW1[0]; dW1[1]] row q, cols 4 jb ..
          const float4 v = ld4(pv + 4 * p);
          const float u = (q < 2) ? 1.0f : pu[2 * p];
          acc_s[0] = fmaf(u, v.x, acc_s[0]);
          acc_s[1] = fmaf(u, v.y, acc_s[1]);
          acc_s[2] = fmaf(u, v.z, acc_s[2]);
          acc_s[3] = fmaf(u, v.w, acc_s[3]);
        } else {  // dW3[lane, :], db3[lane], db3[lane + 32]
          const float h = ph[4 * p];
          const float* dbp = s_db + p * O;
#pragma unroll
          for (int o = 0; o < kOwn3; ++o) {
            if (kO || o < O) acc3[o] = fmaf(h, dbp[o], acc3[o]);
          }
          if (lane < O) acc_b3[0] += dbp[lane];
          if (lane + 32 < O) acc_b3[1] += dbp[lane + 32];
        }
      }
    }
    // dgrid_kv of the row: fixed-order block sum
    float gs[2] = {gx, gy};
    block_sum<kThreads>(gs, s_red);
    if (t == 0) {
      dgrid_kv[2 * r] = gs[0];
      dgrid_kv[2 * r + 1] = gs[1];
    }
  }

  // the second group's sums, added to the first's
  constexpr int kSlots = 16 + 4 + kOwn3 + 2;
  static_assert(kSlots * kGroup <= 4 * kTile, "fits the tiles");
  float* s_x = s_h1;  // [kSlots][kGroup] over the tiles, free now
  __syncthreads();
  const int lt = t % kGroup;
  if (g == 1) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) s_x[(4 * x + y) * kGroup + lt] = acc[x][y];
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) s_x[(16 + x) * kGroup + lt] = acc_s[x];
#pragma unroll
    for (int o = 0; o < kOwn3; ++o) s_x[(20 + o) * kGroup + lt] = acc3[o];
    s_x[(20 + kOwn3) * kGroup + lt] = acc_b3[0];
    s_x[(21 + kOwn3) * kGroup + lt] = acc_b3[1];
  }
  __syncthreads();
  if (g == 1) return;
  float* out = partial + static_cast<size_t>(blockIdx.x) * num_params(O);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      out[kOffW2 + (4 * ib + x) * kHid + 4 * jb + y] =
          acc[x][y] + s_x[(4 * x + y) * kGroup + lt];
    }
  }
  if (wg == 0) {
    const int base = (q == 0) ? kOffB2 : (q == 1) ? kOffB1 : (q - 2) * kHid;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      out[base + 4 * jb + x] = acc_s[x] + s_x[(16 + x) * kGroup + lt];
    }
  } else {
#pragma unroll
    for (int o = 0; o < kOwn3; ++o) {
      if (kO || o < O) {
        out[kOffW3 + lane * O + o] = acc3[o] + s_x[(20 + o) * kGroup + lt];
      }
    }
    const int b3 = kOffW3 + kHid * O;
    if (lane < O) out[b3 + lane] = acc_b3[0] + s_x[(20 + kOwn3) * kGroup + lt];
    if (lane + 32 < O) {
      out[b3 + lane + 32] = acc_b3[1] + s_x[(21 + kOwn3) * kGroup + lt];
    }
  }
}

template <int kO>
int launch_partial(const float* const* a, const float* dbias, float* dgrid_kv,
                   float* partial, int rows, int K, int N, int O, int nparts,
                   int nk, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(smem_floats(O)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      cpb_exact_bwd_partial_kernel<kO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = (rows + nparts - 1) / nparts;
  cpb_exact_bwd_partial_kernel<kO><<<nparts, kThreads, smem, s>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], dbias, dgrid_kv, partial,
      rows, K, N, O, rows_per_block, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid_q [N, 2], grid_kv [rows, 2] with rows = BH * K, w1 [2, 32], b1 [32],
// w2 [32, 32], b2 [32], w3 [32, O], dbias [BH, O, K, N] (nk = 0) or
// [BH, O, N, K] (nk = 1), all f32 ->
// dgrid_kv [rows, 2] and grads, the flat concatenation of dW1 [2, 32],
// db1 [32], dW2 [32, 32], db2 [32], dW3 [32, O], db3 [O].  partial is
// scratch of nparts * num_params(O) f32; block b takes rows
// [b * ceil(rows / nparts), ...).  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int dmlt_cpb_exact_bwd(const void* grid_q, const void* grid_kv,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* w3, const void* dbias,
                                  void* dgrid_kv, void* grads, void* partial,
                                  int rows, int K, int N, int O, int nparts,
                                  int nk, void* stream) {
  if (rows == 0 || N == 0 || nparts <= 0) return 0;
  if (O < 1 || O > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  const float* args[] = {
      static_cast<const float*>(grid_q), static_cast<const float*>(grid_kv),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3)};
  const float* db = static_cast<const float*>(dbias);
  float* dg = static_cast<float*>(dgrid_kv);
  float* part = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      O == 1   ? launch_partial<1>(args, db, dg, part, rows, K, N, O, nparts, nk, s)
      : O == 2 ? launch_partial<2>(args, db, dg, part, rows, K, N, O, nparts, nk, s)
               : launch_partial<0>(args, db, dg, part, rows, K, N, O, nparts, nk, s);
  if (err != 0) return err;
  return sum_partials(partial, nparts, num_params(O), grads, s);
}

// Bytes of dynamic shared memory a K2-bwd block takes at O output channels.
extern "C" int dmlt_cpb_exact_bwd_smem(int O) {
  return static_cast<int>(smem_floats(O) * sizeof(float));
}
