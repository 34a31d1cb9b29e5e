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
// f32 outside the tensor cores); the inputs are 5 MB.  No tensor cores, no
// TF32 and no fast-math in this version: every d2 is the f32 value the plain
// version forms, up to the dot's summation order.
//
// What the design does about that: one block per (batch, tile of 64
// tokens), with 4 threads per token, each taking every 4th tile of 32
// neighbour rows (a thread per token alone gives B * N = 10,000 threads,
// ~2 warps per SM at the production shape: K3-knn took 0.96 ms that way on
// an H100 at 700 W, 0.47 ms with 4 threads per token).  The block keeps
// its own tokens in shared memory transposed ([C][64 + 1]: the padded
// stride makes both the transposing store and the per-thread column reads
// free of bank conflicts), and each of the 4 segments streams its
// neighbour tiles (and their x2 and densities) through its own
// shared-memory buffer.  Each thread keeps 32 dot
// accumulators, one per neighbour of the tile, and reads each neighbour's
// row as float4 broadcasts (all threads of a warp read the same address),
// so four FMAs cost one shared-memory load.  The k-smallest multiset lives
// in registers as a sorted array of 8, updated by a branch-free insertion
// that keeps duplicates; at the end the 4 segments' arrays (and row max,
// parent min) meet in shared memory and the first segment merges them:
// the 8 smallest of a union of multisets are the 8 smallest of the
// segments' 8 smallest, so the result does not depend on the split.  The
// caller takes the first k.  Tokens past N are skipped by bounds checks
// (the TPU pads N to 512 and masks).  Not yet done: tensor-core dots.

#include <cuda_runtime.h>

namespace {

constexpr int kTokens = 64;  // tokens per block
constexpr int kSegs = 4;     // threads per token, each on every kSegs-th tile
constexpr int kThreads = kTokens * kSegs;
constexpr int kStride = kTokens + 1;  // padded stride of the transposed tile
constexpr int kNbr = 32;  // neighbour rows per shared-memory tile
constexpr int kKMax = 8;  // size of the k-smallest multiset
constexpr float kBig = 3.0e38f;  // the TPU kernel's _BIG

// float4s of the neighbour-tile buffers, which also hold the segments'
// partial results at the end ([kSegs][kKMax + 1][kTokens] floats)
__host__ __device__ __forceinline__ int tiles_f4(int c) {
  const int tiles = kSegs * kNbr * (c / 4);
  const int partials = kSegs * (kKMax + 1) * kTokens / 4;
  return tiles > partials ? tiles : partials;
}

// insert v into the ascending multiset best[kKMax], dropping the largest
__device__ __forceinline__ void insert(float (&best)[kKMax], float v) {
#pragma unroll
  for (int s = 0; s < kKMax; ++s) {
    const float lo = fminf(best[s], v);
    v = fmaxf(best[s], v);
    best[s] = lo;
  }
}

template <bool kParent>
__global__ void __launch_bounds__(kThreads)
dpc_stream_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                  const float* __restrict__ density, int n, int c,
                  float* __restrict__ knn, int k, float* __restrict__ rmax,
                  float* __restrict__ parent) {
  extern __shared__ float4 smem4[];
  const int c4n = c / 4;
  float* sxi = reinterpret_cast<float*>(smem4);  // [c][kStride]
  const int tile4 = kNbr * c4n;  // float4s of one neighbour tile
  float4* sxj_all = smem4 + (c * kStride + 3) / 4;  // [kSegs][kNbr][c4n]
  float* sx2_all = reinterpret_cast<float*>(sxj_all + tiles_f4(c));
  float* sdn_all = sx2_all + kSegs * kNbr;  // [kSegs][kNbr] each

  const int b = blockIdx.y;
  const int t = threadIdx.x;    // token of the block
  const int seg = threadIdx.y;  // segment of the neighbour tiles
  const int tid = seg * kTokens + t;
  const int i0 = blockIdx.x * kTokens;
  const int i = i0 + t;
  const bool live = i < n;
  const float4* xb = reinterpret_cast<const float4*>(x) +
                     static_cast<size_t>(b) * n * c4n;
  const float* x2b = x2 + static_cast<size_t>(b) * n;
  const float* db = kParent ? density + static_cast<size_t>(b) * n : nullptr;
  float4* sxj = sxj_all + seg * tile4;
  float* sx2 = sx2_all + seg * kNbr;
  float* sdn = sdn_all + seg * kNbr;

  // this block's tokens, transposed (tokens past n as zeros)
  for (int e = tid; e < kTokens * c4n; e += kThreads) {
    const int r = e / c4n;
    const int q = e - r * c4n;
    const float4 v = i0 + r < n ? xb[static_cast<size_t>(i0) * c4n + e]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    float* col = sxi + 4 * q * kStride + r;
    col[0] = v.x;
    col[kStride] = v.y;
    col[2 * kStride] = v.z;
    col[3 * kStride] = v.w;
  }
  const float x2i = live ? x2b[i] : 0.f;
  const float di = kParent && live ? db[i] : 0.f;

  float best[kKMax];
#pragma unroll
  for (int s = 0; s < kKMax; ++s) best[s] = kBig;
  float row_max = -kBig;
  float pmin = kBig;

  const int tiles = (n + kNbr - 1) / kNbr;
  for (int it = seg; it - seg < tiles; it += kSegs) {
    // every segment runs the same number of rounds (the barriers are for
    // the whole block); a segment past the last tile loads and uses none
    const int j0 = it * kNbr;
    const int nj = max(0, min(kNbr, n - j0));
    __syncthreads();  // the previous tiles are consumed
    const float4* src = xb + static_cast<size_t>(j0) * c4n;
    for (int e = t; e < tile4; e += kTokens)
      sxj[e] = e < nj * c4n ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < kNbr) {
      sx2[t] = t < nj ? x2b[j0 + t] : 0.f;
      if (kParent) sdn[t] = t < nj ? db[j0 + t] : 0.f;
    }
    __syncthreads();
    if (nj == 0) continue;

    float acc[kNbr];
#pragma unroll
    for (int j = 0; j < kNbr; ++j) acc[j] = 0.f;
    for (int q = 0; q < c4n; ++q) {
      const float* col = sxi + 4 * q * kStride + t;
      const float a0 = col[0];
      const float a1 = col[kStride];
      const float a2 = col[2 * kStride];
      const float a3 = col[3 * kStride];
#pragma unroll
      for (int j = 0; j < kNbr; ++j) {
        const float4 v = sxj[j * c4n + q];
        acc[j] = fmaf(a0, v.x, acc[j]);
        acc[j] = fmaf(a1, v.y, acc[j]);
        acc[j] = fmaf(a2, v.z, acc[j]);
        acc[j] = fmaf(a3, v.w, acc[j]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < kNbr; ++j) {
      if (j < nj) {
        // the plain version's expression, each op rounded on its own
        const float d =
            __fsub_rn(__fadd_rn(sx2[j], x2i), __fmul_rn(2.f, acc[j]));
        if (kParent) {
          if (sdn[j] > di) pmin = fminf(pmin, d);
        } else {
          row_max = fmaxf(row_max, d);
          if (d < best[kKMax - 1]) insert(best, d);
        }
      }
    }
  }

  // the segments meet in the tile buffers
  __syncthreads();
  float* part = reinterpret_cast<float*>(sxj_all);
  const int slot = kKMax + 1;
  if (seg > 0) {
    float* mine = part + (seg * slot) * kTokens + t;
    if (kParent) {
      mine[0] = pmin;
    } else {
#pragma unroll
      for (int s = 0; s < kKMax; ++s) mine[s * kTokens] = best[s];
      mine[kKMax * kTokens] = row_max;
    }
  }
  __syncthreads();
  if (seg > 0 || !live) return;
  for (int o = 1; o < kSegs; ++o) {
    const float* other = part + (o * slot) * kTokens + t;
    if (kParent) {
      pmin = fminf(pmin, other[0]);
    } else {
#pragma unroll
      for (int s = 0; s < kKMax; ++s) {
        const float v = other[s * kTokens];
        if (v < best[kKMax - 1]) insert(best, v);
      }
      row_max = fmaxf(row_max, other[kKMax * kTokens]);
    }
  }
  const size_t row = static_cast<size_t>(b) * n + i;
  if (kParent) {
    parent[row] = pmin;
  } else {
    rmax[row] = row_max;
#pragma unroll
    for (int s = 0; s < kKMax; ++s)
      if (s < k) knn[row * k + s] = best[s];
  }
}

size_t smem_bytes(int c) {
  return sizeof(float4) * ((c * kStride + 3) / 4 + tiles_f4(c)) +
         sizeof(float) * 2 * kSegs * kNbr;
}

template <bool kParent>
int launch(const void* x, const void* x2, const void* density, int batch,
           int n, int c, void* knn, int k, void* rmax, void* parent,
           void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      dpc_stream_kernel<kParent>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kTokens - 1) / kTokens, batch);
  const dim3 block(kTokens, kSegs);
  dpc_stream_kernel<kParent><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2),
      static_cast<const float*>(density), n, c, static_cast<float*>(knn), k,
      static_cast<float*>(rmax), static_cast<float*>(parent));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers (ops/dpc_knn.py) check what these entry points assume:
// contiguous f32 on one card, x 16-byte aligned, c a multiple of 4 with
// dmlt_dpc_smem_bytes(c) within the card's shared memory, 1 <= k <= 8.
// Each returns cudaGetLastError() after its launch (0 = launched).

// x [batch, n, c], x2 [batch, n] -> knn [batch, n, k] (ascending),
// rmax [batch, n]
extern "C" int dmlt_dpc_knn(const void* x, const void* x2, int batch, int n,
                            int c, int k, void* knn, void* rmax,
                            void* stream) {
  return launch<false>(x, x2, nullptr, batch, n, c, knn, k, rmax, nullptr,
                       stream);
}

// x [batch, n, c], x2 [batch, n], density [batch, n] -> parent [batch, n]
extern "C" int dmlt_dpc_parent(const void* x, const void* x2,
                               const void* density, int batch, int n, int c,
                               void* parent, void* stream) {
  return launch<true>(x, x2, density, batch, n, c, nullptr, 0, nullptr,
                      parent, stream);
}

// shared memory one block of either kernel takes at channel count c
extern "C" int dmlt_dpc_smem_bytes(int c) {
  return static_cast<int>(smem_bytes(c));
}
