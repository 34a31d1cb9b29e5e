// K3: the two streaming distance passes of DPC-KNN clustering.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/dpc_knn.py
// _knn_kernel (K3-knn) and _parent_kernel (K3-parent), called there through
// _stream_calls / dpc_knn_cluster_streamed.
//
// What they compute, per batch b and token i of x [B, N, C] f32, with the
// squared distances
//     d2(i, j) = (x2[j] + x2[i]) - 2 * dot(x_i, x_j),   x2 = |x|^2 per token
// (x2 comes from the caller, so the kernels and their plain versions in
// ops/dpc_knn.py differ only in the order of the dot's sum):
//   K3-knn:    the k <= 8 smallest d2(i, .) over all j (self included) as a
//              multiset, ascending (a value that occurs twice is kept twice,
//              as the TPU kernel's first-occurrence masking keeps it), and
//              the row max of d2(i, .);
//   K3-parent: the min of d2(i, j) over the j of strictly higher density
//              (density[j] > density[i]), or 3e38 where there is none.
// The [B, N, N] distance matrix is never written.
//
// What bounds them on the card: the dot products, 2 * B * N^2 * C flops per
// call (6.4 GFLOP at B=4, N=2500, C=128: 0.096 ms at the H100's 67 TFLOP/s
// f32 outside the tensor cores); the inputs are 5 MB.  Every dot is an f32
// FMA chain over the channels in ascending order, with no tensor cores and
// no fast-math, so every d2 is the f32 value the plain version forms, up to
// the dot's summation order (3xTF32 tensor-core products are not used: at
// C < 32 their split error alone could exceed what chip_smoke.py's
// K3_TOL_ULPS argument allows an f32 sum).
//
// What the design does about that.  B * N is only 10,000 rows at the
// production shape, so one block per tile of tokens (the TPU's grid, and
// this kernel's design before) leaves most of the card idle.  Here the work
// is the pairs of a token tile (64 tokens) and a neighbour tile (128
// neighbours), token tile major, and one wave of blocks (two an SM; the
// plan, ops/dpc_knn.py dpc_plan) takes equal runs of them: 12 or 13 pairs a
// block at the production shape, so the neighbour axis of a token tile is
// split across the two or three blocks whose runs cover it, and no block
// waits in a second wave.  A block writes each run's partial result, the
// k-smallest multiset and the row max (K3-knn) or the min (K3-parent) of
// each token, to a scratch buffer; a finishing kernel, one thread per
// token, merges the partials of the blocks that cover its tile in block
// order: the k smallest of a union of multisets are the k smallest of the
// parts' k smallest, and min and max do not depend on order, so the result
// is the same at every block count and bitwise the same from call to call,
// with no atomics.
//
// Inside a block (8 warps), the products are an SGEMM-style register tile:
// each thread holds 8 tokens x 4 neighbours of the 64 x 128 pair in 32
// accumulators and reads both operands as float4 along the channels from
// shared memory (12 loads for 128 FMAs; the 8 token loads are warp-wide
// broadcasts).  The run's tokens stay in shared memory, zero-padded to a
// multiple of 32 channels; the neighbour tiles stream through a three-stage
// ring of 32-channel slices by cp.async, two slices in flight while the
// block computes on a third, one block barrier a slice, a tile's |x|^2 and
// densities with its first slice.  After a tile's last slice each thread
// forms its 32 d2 values as the plain version rounds them; its tokens' row
// max (or min over the higher-density neighbours) stays in registers, and
// for K3-knn each warp passes its d2 values, 32 neighbours at a time,
// through a d2 tile of its own in shared memory (no block barrier), where
// four lanes per token (8 neighbours each) update their multiset by a
// branch-free insertion that keeps duplicates; the lanes meet by shuffles
// at the end of a run.  The multiset is k values long (an instance per k <=
// 8): fewer values to insert into and fewer insertions than a fixed 8.
// Tokens and neighbours past N are zero-filled and skipped (the TPU pads N
// to 512 and masks).

#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp.async

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRM = 8;    // tokens per thread: warp + kWarps r
constexpr int kRN = 4;    // neighbours per thread: lane + 32 q
constexpr int kTM = kWarps * kRM;  // tokens per token tile
constexpr int kTN = 32 * kRN;      // neighbours per neighbour tile
constexpr int kKC = 32;   // channels per slice of the ring
constexpr int kStages = 3;  // slices in the ring (kStages - 1 in flight)
constexpr int kLdb = kKC + 4;  // padded row of a ring slice (float4 reads
                               // of 8 rows fall in distinct banks)
constexpr int kLdw = 33;  // padded row of a warp's d2 tile (kRM x 32)
constexpr int kCopies = kTN * (kKC / 4) / kThreads;  // cp.async a slice
constexpr float kBig = 3.0e38f;  // the TPU kernel's _BIG

static_assert(kCopies * kThreads == kTN * (kKC / 4), "whole slices");
static_assert(32 % kRM == 0, "whole lanes a token in the selection");
static_assert(kThreads == 2 * kTN, "a thread per neighbour for x2, density");

// channels of the token tile, zero-padded to whole slices
__host__ __device__ __forceinline__ int padded_c(int c) {
  return (c + kKC - 1) / kKC * kKC;
}

// The work: item (t, u) is token tile t (of batch * ceil(n / kTM), batch
// major) against neighbour tile u (of ceil(n / kTN)); items run t-major.
// Block p of P takes items [lo(p), lo(p + 1)), lo(p) = ceil(p items / P):
// at most two runs of one token tile each when P >= the token tiles.
struct Work {
  int tt;         // token tiles of a bag
  int nt;         // neighbour tiles
  long long items;
  __host__ __device__ Work(int batch, int n)
      : tt((n + kTM - 1) / kTM),
        nt((n + kTN - 1) / kTN),
        items(static_cast<long long>(batch) * tt * nt) {}
  __host__ __device__ long long lo(long long p, long long blocks) const {
    return (p * items + blocks - 1) / blocks;
  }
  // the block whose run holds item it
  __host__ __device__ long long block_of(long long it,
                                         long long blocks) const {
    return it * blocks / items;
  }
};

// a block's place in its slices: slice ch of neighbour tile u of token
// tile t (of bag b), and how many tiles it has begun
struct Cursor {
  int t, b, u, ch, tiles;
  __device__ void next(int nch, const Work& work) {
    if (++ch < nch) return;
    ch = 0;
    ++tiles;
    if (++u < work.nt) return;
    u = 0;
    b = ++t / work.tt;
  }
};

// 4 bytes from global to shared memory, asynchronously; zero when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// insert v into the ascending multiset best[K], dropping the largest
template <int K>
__device__ __forceinline__ void insert(float (&best)[K], float v) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float lo = fminf(best[s], v);
    v = fmaxf(best[s], v);
    best[s] = lo;
  }
}

// v[r] reduced over the warp's 32 lanes (max, or min), returned for r = rho
template <bool kMax>
__device__ __forceinline__ float warp_reduce_pick(float (&v)[kRM], int rho) {
  float out = 0.f;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    float x = v[r];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float y = __shfl_xor_sync(0xffffffffu, x, off);
      x = kMax ? fmaxf(x, y) : fminf(x, y);
    }
    if (r == rho) out = x;
  }
  return out;
}

// Block p: its run of items, one or two token tiles.  Warp w holds tokens
// w + kWarps r (r < kRM) of the token tile against neighbours lane + 32 q
// of each neighbour tile: every lane of a warp reads the same token row (a
// broadcast).  The row max (K3-knn) or the min (K3-parent) of each of a
// thread's tokens is a register; K3-knn's multiset is selected from the
// warp's d2 tile, row r the token w + kWarps r, lane l selecting for row
// l % kRM over columns (l / kRM) * kRM .. + kRM - 1 of each 32-wide pass.
// A neighbour tile's |x|^2 (and densities) come with its first slice.  At
// the end of a run the block writes its partials for that token tile:
//   K3-knn:    part[p][run][s][token], s < K the ascending multiset,
//              s = K the row max;
//   K3-parent: part[p][run][token], the min.
template <bool kParent, int K>
__global__ void __launch_bounds__(kThreads, 2)
dpc_split_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                 const float* __restrict__ density, int batch, int n, int c,
                 float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int cp = padded_c(c);
  const int la = cp + 4;  // padded row of the token tile
  float* sA = reinterpret_cast<float*>(smem4);  // [kTM][la]
  float* sB = sA + kTM * la;                    // [kStages][kTN][kLdb]
  float* sW = sB + kStages * kTN * kLdb;        // [kWarps][kRM][kLdw]
  float* sx2 = sW + kWarps * kRM * kLdw;        // [kTM]
  float* sdn = sx2 + kTM;                       // [kTM]
  float* sx2j = sdn + kTM;                      // [kStages][kTN]
  float* sdnj = sx2j + kStages * kTN;           // [kStages][kTN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rho = lane % kRM;  // selection: row rho of the warp's tile,
  const int seg = lane / kRM;  //            columns seg * kRM .. + kRM - 1
  float* wt = sW + warp * kRM * kLdw;
  const Work work(batch, n);
  const long long lo = work.lo(blockIdx.x, gridDim.x);
  const long long hi = work.lo(blockIdx.x + 1, gridDim.x);
  if (lo >= hi) return;
  const int nch = cp / kKC;
  const int steps = static_cast<int>(hi - lo) * nch;  // slices
  const int t_first = static_cast<int>(lo / work.nt);
  Cursor at{t_first, t_first / work.tt, static_cast<int>(lo % work.nt), 0, 0};
  Cursor ahead = at;  // the next slice to issue

  // the token tile t of bag b into sA, sx2, sdn (rows past n, channels
  // past c as zeros); its copies join the next cp.async group
  auto load_tokens = [&](int t, int b) {
    const int i0 = (t - b * work.tt) * kTM;
    const float* xb = x + static_cast<size_t>(b) * n * c;
    const int cp4 = cp / 4;
    for (int e = tid; e < kTM * cp4; e += kThreads) {
      const int r = e / cp4;
      const int q = e - r * cp4;
      const bool in = i0 + r < n && 4 * q < c;
      cp_async16(sA + r * la + 4 * q,
                 in ? xb + static_cast<size_t>(i0 + r) * c + 4 * q : x, in);
    }
    if (tid < kTM) {
      const bool in = i0 + tid < n;
      const size_t i = static_cast<size_t>(b) * n + i0 + tid;
      sx2[tid] = in ? x2[i] : 0.f;
      if (kParent) sdn[tid] = in ? density[i] : 0.f;
    }
  };
  // the slice at `ahead` into ring stage g: each thread copies rows tid / 8
  // + 32 m, channels 4 (tid % 8) ..; with a tile's first slice, its |x|^2
  // (threads 0 .. 127) and densities (threads 128 .. 255)
  auto issue = [&](int g) {
    const int j0 = ahead.u * kTN;
    const int c0 = ahead.ch * kKC + 4 * (tid % (kKC / 4));
    const float* xb = x + static_cast<size_t>(ahead.b) * n * c + c0;
    float* dst = sB + (g % kStages) * kTN * kLdb + 4 * (tid % (kKC / 4));
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int r = tid / (kKC / 4) + m * (kThreads / (kKC / 4));
      const bool in = j0 + r < n && c0 < c;
      cp_async16(dst + r * kLdb,
                 in ? xb + static_cast<size_t>(j0 + r) * c : x, in);
    }
    if (ahead.ch == 0) {
      const int slot = (ahead.tiles % kStages) * kTN;
      const int r = tid % kTN;
      const bool in = j0 + r < n;
      const size_t j = static_cast<size_t>(ahead.b) * n + j0 + r;
      if (tid < kTN)
        cp_async4(sx2j + slot + r, in ? x2 + j : x2, in);
      else if (kParent)
        cp_async4(sdnj + slot + r, in ? density + j : density, in);
    }
    ahead.next(nch, work);
  };

  load_tokens(at.t, at.b);
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < steps) issue(g);
    cp_async_commit();
  }

  float acc[kRM][kRN];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int q = 0; q < kRN; ++q) acc[r][q] = 0.f;
  float best[K];
  float row[kRM];  // per token: the row max (K3-knn) or the min (K3-parent)
  auto reset = [&]() {
#pragma unroll
    for (int s = 0; s < K; ++s) best[s] = kBig;
#pragma unroll
    for (int r = 0; r < kRM; ++r) row[r] = kParent ? kBig : -kBig;
  };
  reset();

  for (int g = 0; g < steps; ++g) {
    cp_async_wait<kStages - 2>();  // slice g (and the tokens) have landed
    __syncthreads();  // ... for every thread, and slice g - 1 is consumed
    if (g + kStages - 1 < steps) issue(g + kStages - 1);
    cp_async_commit();
    const float* a = sA + at.ch * kKC;
    const float* bs = sB + (g % kStages) * kTN * kLdb;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 bv[kRN];
#pragma unroll
      for (int q = 0; q < kRN; ++q)
        bv[q] = *reinterpret_cast<const float4*>(bs + (lane + 32 * q) * kLdb +
                                                 kk);
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(
            a + (warp + kWarps * r) * la + kk);
        // one FMA chain per (token, neighbour), in ascending channels
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          acc[r][q] = fmaf(av.x, bv[q].x, acc[r][q]);
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          acc[r][q] = fmaf(av.y, bv[q].y, acc[r][q]);
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          acc[r][q] = fmaf(av.z, bv[q].z, acc[r][q]);
#pragma unroll
        for (int q = 0; q < kRN; ++q)
          acc[r][q] = fmaf(av.w, bv[q].w, acc[r][q]);
      }
    }
    if (at.ch != nch - 1) {
      at.next(nch, work);
      continue;
    }

    // the tile's d2 values, 32 neighbours at a time
    const int j0 = at.u * kTN;
    const float* x2j = sx2j + (at.tiles % kStages) * kTN;
    const float* dnj = sdnj + (at.tiles % kStages) * kTN;
#pragma unroll
    for (int q = 0; q < kRN; ++q) {
      const int jl = lane + 32 * q;
      const bool in = j0 + jl < n;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int i = warp + kWarps * r;
        // the plain version's expression, each op rounded on its own
        const float d = __fsub_rn(__fadd_rn(x2j[jl], sx2[i]),
                                  __fmul_rn(2.f, acc[r][q]));
        acc[r][q] = 0.f;
        if (kParent) {
          if (in && dnj[jl] > sdn[i]) row[r] = fminf(row[r], d);
        } else {
          if (in) row[r] = fmaxf(row[r], d);
          wt[r * kLdw + lane] = d;
        }
      }
      if (!kParent) {
        // each row's multiset over this pass's valid neighbours
        __syncwarp();
        const float* wr = wt + rho * kLdw + seg * kRM;
        const int m = min(kRM, n - (j0 + 32 * q + kRM * seg));  // maybe <= 0
        for (int jj = 0; jj < m; ++jj) {
          const float d = wr[jj];
          if (d < best[K - 1]) insert(best, d);
        }
        __syncwarp();
      }
    }

    // the end of a run: the block's partials for its token tile
    const bool last = g == steps - 1;
    const int t = at.t;
    at.next(nch, work);
    if (!last && at.t == t) continue;
    const int run = t == t_first ? 0 : 1;
    const float r_out = warp_reduce_pick<!kParent>(row, rho);
    const int i = warp + kWarps * rho;  // the token of row rho
    if (kParent) {
      if (seg == 0)
        part[(static_cast<size_t>(blockIdx.x) * 2 + run) * kTM + i] = r_out;
    } else {
      // the 32 / kRM lanes of each row meet by shuffles
#pragma unroll
      for (int off = kRM; off < 32; off *= 2) {
        float other[K];
#pragma unroll
        for (int s = 0; s < K; ++s)
          other[s] = __shfl_xor_sync(0xffffffffu, best[s], off);
#pragma unroll
        for (int s = 0; s < K; ++s)
          if (other[s] < best[K - 1]) insert(best, other[s]);
      }
      if (seg == 0) {
        float* out = part + (static_cast<size_t>(blockIdx.x) * 2 + run) *
                                (K + 1) * kTM + i;
#pragma unroll
        for (int s = 0; s < K; ++s) out[s * kTM] = best[s];
        out[K * kTM] = r_out;
      }
    }
    if (last) break;
    // the next run: its token tile, once every warp is done with this one
    reset();
    cp_async_wait<0>();
    __syncthreads();
    load_tokens(at.t, at.b);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
}

// One thread per token: the partials of the blocks whose runs cover its
// token tile, merged in block order.
template <bool kParent, int K>
__global__ void __launch_bounds__(64)
dpc_finish_kernel(const float* __restrict__ part, int batch, int n,
                  int blocks, float* __restrict__ knn,
                  float* __restrict__ rmax, float* __restrict__ parent) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch * n) return;
  const Work work(batch, n);
  const int b = row / n;
  const int i = row - b * n;
  const int t = b * work.tt + i / kTM;
  const long long first = static_cast<long long>(t) * work.nt;
  const long long p0 = work.block_of(first, blocks);
  const long long p1 = work.block_of(first + work.nt - 1, blocks);
  const int words = kParent ? 1 : K + 1;
  auto src = [&](long long p) {
    const int run = work.lo(p, blocks) / work.nt == t ? 0 : 1;
    return part + (p * 2 + run) * words * kTM + i % kTM;
  };
  if (kParent) {
    float m = *src(p0);
    for (long long p = p0 + 1; p <= p1; ++p) m = fminf(m, *src(p));
    parent[row] = m;
    return;
  }
  const float* s0 = src(p0);
  float best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = s0[s * kTM];
  float row_max = s0[K * kTM];
  for (long long p = p0 + 1; p <= p1; ++p) {
    const float* other = src(p);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float v = other[s * kTM];
      if (v < best[K - 1]) insert(best, v);
    }
    row_max = fmaxf(row_max, other[K * kTM]);
  }
  rmax[row] = row_max;
#pragma unroll
  for (int s = 0; s < K; ++s) knn[static_cast<size_t>(row) * K + s] = best[s];
}

size_t smem_bytes(int c) {
  return sizeof(float) * (static_cast<size_t>(kTM) * (padded_c(c) + 4) +
                          kStages * kTN * kLdb + kWarps * kRM * kLdw +
                          2 * kTM + 2 * kStages * kTN);
}

template <bool kParent, int K>
int launch(const void* x, const void* x2, const void* density, int batch,
           int n, int c, int blocks, void* part, void* knn, void* rmax,
           void* parent, void* stream) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      dpc_split_kernel<kParent, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  dpc_split_kernel<kParent, K><<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(density), batch, n, c,
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * n;
  dpc_finish_kernel<kParent, K><<<(rows + 63) / 64, 64, 0, s>>>(
      static_cast<const float*>(part), batch, n, blocks,
      static_cast<float*>(knn), static_cast<float*>(rmax),
      static_cast<float*>(parent));
  return static_cast<int>(cudaGetLastError());
}

// nothing to do for empty bags; the plan's bounds on the block count
bool skip(int batch, int n, int blocks, int* err) {
  *err = 0;
  if (batch == 0 || n == 0) return true;
  const Work work(batch, n);
  if (blocks < batch * work.tt || blocks > work.items) {
    *err = static_cast<int>(cudaErrorInvalidValue);
    return true;
  }
  return false;
}

}  // namespace

// The wrappers (ops/dpc_knn.py) check what these entry points assume:
// contiguous f32 on one card, x 16-byte aligned, c a multiple of 4 with
// dmlt_dpc_smem_bytes(c) within the card's shared memory, 1 <= k <= 8, and
// the plan's block count (dpc_plan: at least the token tiles, batch *
// ceil(n / 64), at most the items, that times ceil(n / 128)) with its
// scratch part: [blocks, 2, k + 1, 64] for K3-knn, [blocks, 2, 64] for
// K3-parent.  Each launches the split kernel and the finishing kernel and
// returns cudaGetLastError() after them (0 = launched).

// x [batch, n, c], x2 [batch, n] -> knn [batch, n, k] (ascending),
// rmax [batch, n]
extern "C" int dmlt_dpc_knn(const void* x, const void* x2, int batch, int n,
                            int c, int k, int blocks, void* part, void* knn,
                            void* rmax, void* stream) {
  int err;
  if (skip(batch, n, blocks, &err)) return err;
  switch (k) {  // one instance per k: the multiset is k values long
#define DMLT_DPC_KNN_CASE(K)                                                 \
  case K:                                                                    \
    return launch<false, K>(x, x2, nullptr, batch, n, c, blocks, part, knn,  \
                            rmax, nullptr, stream);
    DMLT_DPC_KNN_CASE(1)
    DMLT_DPC_KNN_CASE(2)
    DMLT_DPC_KNN_CASE(3)
    DMLT_DPC_KNN_CASE(4)
    DMLT_DPC_KNN_CASE(5)
    DMLT_DPC_KNN_CASE(6)
    DMLT_DPC_KNN_CASE(7)
    DMLT_DPC_KNN_CASE(8)
#undef DMLT_DPC_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [batch, n, c], x2 [batch, n], density [batch, n] -> parent [batch, n]
extern "C" int dmlt_dpc_parent(const void* x, const void* x2,
                               const void* density, int batch, int n, int c,
                               int blocks, void* part, void* parent,
                               void* stream) {
  int err;
  if (skip(batch, n, blocks, &err)) return err;
  return launch<true, 1>(x, x2, density, batch, n, c, blocks, part, nullptr,
                         nullptr, parent, stream);
}

// shared memory one block of either kernel takes at channel count c
extern "C" int dmlt_dpc_smem_bytes(int c) {
  return static_cast<int>(smem_bytes(c));
}
