// K1-bwd: gradient of the divisor-1 table-interpolated CPB bias windows.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_d1_bwd_kernel (the TPU kernel behind the custom VJP of _table_interp
// at divisor 1, _tbl_vjp_bwd).
//
// What it computes: for every row r of R rows, with taps (y0, x0),
// fractions (fy, fx), the table window W = T[y0.., x0..] of (side+1)^2
// values and the window cotangent dw [side, side] (the forward is
// cpb_table.cu: out = x-blend(y-blend(W))),
//     m(y, x')  = dw(y, x') * (1-fx) + dw(y, x'-1) * fx     x' in [0, side]
//     dT[y0+y', x0+x'] += m(y', x') * (1-fy) + m(y'-1, x') * fy
//     dfy = sum m(y, x') * (W[y+1, x'] - W[y, x'])
//     dfx = sum dw(y, x) * (a(y, x+1) - a(y, x)),  a = y-blend of W
// (the algebra of _tbl_d1_bwd_kernel, without its sublane rolls or its
// lane-split two-copy table).  Out-of-range terms (dw at x = -1 or side,
// m at y = -1 or side) are zero.  A clipped row (fraction outside [0, 1])
// extrapolates in the forward, and its shift cotangent is that of the
// extrapolation: nothing is masked, as in the TPU kernel.
//
// What bounds it on the card: reading the window cotangent.  At production
// shapes (R = 4608, side = 50, tn = 139) a call reads 46 MB of dw (counted
// from the shapes) and writes a 77 KB table cotangent; each row scatters
// (side+1)^2 = 2601 values into that table, and the table receives about
// 620 contributions per entry.
//
// What the design does about that, and why it is deterministic: blocks
// run in no order, so f32 atomics into dT would make every training step
// non-reproducible.  Instead each block owns a partial dT in shared memory
// (tn^2 f32 = 77 KB, above the 48 KB default, so the launch opts in) and
// takes a fixed run of rows one after another, with a barrier between
// rows.  Within one row the (side+1)^2 targets are distinct, so each
// thread adds to its own entries with no atomics.  The block writes its
// partial table to device memory; a second kernel sums the partials in
// block order.  dfy and dfx of a row are block sums in a fixed tree order
// (warp shuffles, then the warps in order).  So two runs on the same inputs
// give bitwise-equal results.  dw is read once, coalesced, into shared
// memory; the x-blended cotangent m is kept there for the scatter.  The
// shift sums cancel heavily (terms O(1), result O(1e-2), the _tbl_sum2d
// note), so everything stays in f32 with no fast-math.

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cpb_table_bwd_partial_kernel(const float* __restrict__ table, int tn_rows,
                             int tn_cols, const int* __restrict__ taps,
                             const float* __restrict__ fracs,
                             const float* __restrict__ dout,
                             float* __restrict__ dfracs,
                             float* __restrict__ partial, int rows, int side,
                             int rows_per_block) {
  extern __shared__ float smem[];
  const int tsize = tn_rows * tn_cols;
  const int w = side + 1;
  float* s_dtab = smem;               // [tn_rows, tn_cols] partial dT
  float* s_win = s_dtab + tsize;      // [w, w] table window
  float* s_dw = s_win + w * w;        // [side, side] window cotangent
  float* s_m = s_dw + side * side;    // [side, w] x-blended cotangent
  float* s_red = s_m + side * w;      // [2 * kWarps]
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) s_dtab[i] = 0.0f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    // same clamp as the forward, so a bad tap cannot write out of bounds
    const int y0 = min(max(taps[2 * r], 0), tn_rows - w);
    const int x0 = min(max(taps[2 * r + 1], 0), tn_cols - w);
    __syncthreads();  // the previous row is done with s_win, s_dw and s_m
    for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
      const int y = i / w;
      s_win[i] = table[static_cast<size_t>(y0 + y) * tn_cols + x0 + i - y * w];
    }
    const float* dwr = dout + static_cast<size_t>(r) * side * side;
    for (int i = threadIdx.x; i < side * side; i += blockDim.x) s_dw[i] = dwr[i];
    __syncthreads();

    const float fy = fracs[2 * r];
    const float fx = fracs[2 * r + 1];
    const float gy = 1.0f - fy;
    const float gx = 1.0f - fx;
    float sy = 0.0f;
    float sx = 0.0f;
    for (int i = threadIdx.x; i < side * w; i += blockDim.x) {
      const int y = i / w;
      const int x = i - y * w;
      const float* t = s_win + y * w + x;
      const float* d = s_dw + y * side + x;
      const float d0 = (x < side) ? d[0] : 0.0f;
      const float m = d0 * gx + ((x > 0) ? d[-1] : 0.0f) * fx;
      s_m[i] = m;
      sy += m * (t[w] - t[0]);
      if (x < side) {
        const float a0 = t[0] * gy + t[w] * fy;
        const float a1 = t[1] * gy + t[w + 1] * fy;
        sx += d0 * (a1 - a0);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
      const int y = i / w;
      const int x = i - y * w;
      const float v = ((y < side) ? s_m[y * w + x] : 0.0f) * gy +
                      ((y > 0) ? s_m[(y - 1) * w + x] : 0.0f) * fy;
      s_dtab[(y0 + y) * tn_cols + x0 + x] += v;
    }
    float s[2] = {sy, sx};
    block_sum<kThreads>(s, s_red);
    if (threadIdx.x == 0) {
      dfracs[2 * r] = s[0];
      dfracs[2 * r + 1] = s[1];
    }
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * tsize;
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) out[i] = s_dtab[i];
}

}  // namespace

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0), fracs
// [rows, 2] f32 (fy, fx), dout [rows, side, side] f32 -> dtable
// [tn_rows, tn_cols] f32 and dfracs [rows, 2] f32 (dfy, dfx).  partial is
// scratch of nparts * tn_rows * tn_cols f32; block b takes rows
// [b * ceil(rows / nparts), ...).  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int dmlt_cpb_table_interp_bwd(const void* table, int tn_rows,
                                         int tn_cols, const void* taps,
                                         const void* fracs, const void* dout,
                                         void* dtable, void* dfracs,
                                         void* partial, int rows, int side,
                                         int nparts, void* stream) {
  if (rows == 0 || nparts <= 0) return 0;
  const size_t w = side + 1;
  const size_t smem = (static_cast<size_t>(tn_rows) * tn_cols + w * w +
                       static_cast<size_t>(side) * side + side * w +
                       2 * kWarps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cpb_table_bwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = (rows + nparts - 1) / nparts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cpb_table_bwd_partial_kernel<<<nparts, kThreads, smem, s>>>(
      static_cast<const float*>(table), tn_rows, tn_cols,
      static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<const float*>(dout), static_cast<float*>(dfracs),
      static_cast<float*>(partial), rows, side, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tsize = tn_rows * tn_cols;
  return sum_partials(partial, nparts, tsize, dtable, s);
}
