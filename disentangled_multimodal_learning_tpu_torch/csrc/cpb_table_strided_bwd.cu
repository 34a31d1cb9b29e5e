// K5-bwd: gradient of the table-interpolated CPB bias windows at lattice
// divisor d >= 2.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_bwd_kernel (the TPU kernel behind the custom VJP of _table_interp
// at divisor >= 2, _tbl_vjp_bwd).
//
// What it computes: for every row r of R rows, with taps (y0, x0),
// fractions (fy, fx), window cotangent dw [side, side] and the four taps
// wYX(y, x) = T[y0+d*y+Y, x0+d*x+X] of the forward (cpb_table_strided.cu:
// out = x-blend(y-blend)),
//     dT[y0+d*y+Y, x0+d*x+X] += dw(y, x) * (X ? fx : 1-fx) * (Y ? fy : 1-fy)
//     dfx = sum dw(y, x) * ((w01 - w00) (1-fy) + (w11 - w10) fy)
//     dfy = sum dw(y, x) * ((w10 - w00) (1-fx) + (w11 - w01) fx)
// (the algebra of _tbl_bwd_kernel, whose dfx subtracts the two y-blends:
// the same value, with less rounding).  A clipped row (fraction outside
// [0, 1]) extrapolates in the forward, and its shift cotangent is that of
// the extrapolation: nothing is masked, as in the TPU kernel.  Under
// cpb_table_bf16 dw arrives in bf16 and is upcast per element; every sum
// is f32.
//
// What bounds it on the card: reading the window cotangent.  At production
// shapes (R = 4608, side = 50) that is 46 MB of dw (23 MB in bf16), and the
// table cotangent is 274^2 (d = 2) or 544^2 (d = 4) f32, counted from the
// shapes; each dw value lands on 4 distinct table entries.
//
// What the design does about that, and why it is deterministic.  K1-bwd's
// design (each block keeps a partial table in shared memory) does not carry
// over: at d = 4 the table cotangent is 1.18 MB, far above the 227 KB a
// block can hold.  Two deterministic designs were open: (a) one partial
// table per block in device memory, summed in block order as K1-bwd's
// are, which writes and reads parts x 1.18 MB (156 MB with one part per
// SM, three times the cotangent itself, and more than the 50 MB L2 holds);
// (b) owner computes, taken here.  The entries T[py + d*oy, px + d*ox] of
// one phase (py, px) are the TPU's phase-decomposed table; a row reaches
// phase py only through its taps y0 + d*i + Y with Y = (py - y0) mod d in
// {0, 1}, at window row i = oy - (y0 + Y - py) / d, with the one weight
// (Y ? fy : 1-fy), and likewise in x.  So each block owns a 16 x 32 tile
// of one phase and one of a few fixed groups of rows, walks the group's
// rows in order, and for each row that reaches its phase adds that row's
// contribution to every entry of the tile that its window covers: a
// contiguous 32-value stretch of a dw row per warp, with the row's weight
// the same for the whole block.  At d >= 2 a row touches an entry at most
// once, so each entry's partial is a sum over the group's rows in row
// order, in one thread, with no atomics; the groups' partial tables (a
// few MB) are then summed in group order (fixed_order_sum.cuh).  The
// groups add blocks where the table has few tiles (6 at d = 2, 2 at
// d = 4, about 1,000 blocks in all), so enough warps are in flight to hide
// the L2 latency of the cotangent reads.  A block stages the taps of 256
// rows at a time in shared memory and compacts, in row order, the rows
// that reach its phase and meet its tile, so it loops over those alone.
// The shift cotangents are per-row sums, so a second kernel takes one
// block per row: it reads the row's dw once, coalesced, with its four taps
// from L2, and sums in a fixed tree order (block_sum).  So two runs on the
// same inputs give bitwise-equal results.  The shift sums cancel heavily
// (terms O(1), result O(1e-2), the _tbl_sum2d note), so everything stays
// in f32 with no fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;  // table rows of a block's tile
constexpr int kTileCols = 32;  // table columns (one warp spans them)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One block per row: dfracs[r] = (dfy, dfx).
template <typename In>
__global__ void __launch_bounds__(kThreads)
strided_dshift_kernel(const float* __restrict__ table, int tn_rows,
                      int tn_cols, const int* __restrict__ taps,
                      const float* __restrict__ fracs,
                      const In* __restrict__ dout, float* __restrict__ dfracs,
                      int side, int d) {
  __shared__ float s_red[2 * kWarps];
  const int r = blockIdx.x;
  const int reach = d * (side - 1) + 2;
  const int y0 = min(max(taps[2 * r], 0), tn_rows - reach);
  const int x0 = min(max(taps[2 * r + 1], 0), tn_cols - reach);
  const float fy = fracs[2 * r];
  const float fx = fracs[2 * r + 1];
  const float gy = 1.0f - fy;
  const float gx = 1.0f - fx;
  const In* dw = dout + static_cast<size_t>(r) * side * side;
  float sy = 0.0f;
  float sx = 0.0f;
  for (int i = threadIdx.x; i < side * side; i += blockDim.x) {
    const int y = i / side;
    const int x = i - y * side;
    const float* t = table + static_cast<size_t>(y0 + d * y) * tn_cols +
                     x0 + d * x;
    const float w00 = __ldg(t);
    const float w01 = __ldg(t + 1);
    const float w10 = __ldg(t + tn_cols);
    const float w11 = __ldg(t + tn_cols + 1);
    const float g = load(dw + i);
    // b - a as a blend of exact neighbour differences (a and b are O(1),
    // b - a is O(h): subtracting the blends would cost 3e-5 to 6e-5
    // relative at divisor 2 to 4)
    sx += g * ((w01 - w00) * gy + (w11 - w10) * fy);
    sy += g * ((w10 - w00) * gx + (w11 - w01) * fx);
  }
  float s[2] = {sy, sx};
  block_sum<kThreads>(s, s_red);
  if (threadIdx.x == 0) {
    dfracs[2 * r] = s[0];
    dfracs[2 * r + 1] = s[1];
  }
}

// One block per 16 x 32 tile of one phase (py, px) of the table (the
// entries T[py + d*oy, px + d*ox]) and group of rows: the tile's partial
// dtable over the group's rows, in row order.
template <typename In>
__global__ void __launch_bounds__(kThreads)
strided_dtable_kernel(const int* __restrict__ taps,
                      const float* __restrict__ fracs,
                      const In* __restrict__ dout, float* __restrict__ partial,
                      int tn_rows, int tn_cols, int rows, int rows_per_group,
                      int side, int d, int groups) {
  __shared__ int s_by[kThreads];     // window row of phase row 0, per row
  __shared__ int s_bx[kThreads];
  __shared__ float s_wy[kThreads];   // the row's weight on this phase
  __shared__ float s_wx[kThreads];
  __shared__ int s_hits[kThreads];   // staged rows that meet the tile, in order
  __shared__ int s_count[kWarps];
  const int reach = d * (side - 1) + 2;
  const int phase = blockIdx.z / groups;
  const int py = phase / d;
  const int px = phase - py * d;
  const int oy0 = blockIdx.y * kTileRows;  // the tile's phase rows
  const int ox0 = blockIdx.x * kTileCols;
  const int ox = ox0 + (threadIdx.x & (kTileCols - 1));
  const int oy = oy0 + threadIdx.x / kTileCols;  // and oy + 8
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.z - phase * groups;
  const int r_begin = g * rows_per_group;
  const int r_end = min(rows, r_begin + rows_per_group);
  float acc[2] = {0.0f, 0.0f};
  for (int c = r_begin; c < r_end; c += kThreads) {
    __syncthreads();  // the previous chunk is done with the staged rows
    const int r = c + threadIdx.x;
    bool hit = false;
    if (r < r_end) {
      const int y0 = min(max(taps[2 * r], 0), tn_rows - reach);
      const int x0 = min(max(taps[2 * r + 1], 0), tn_cols - reach);
      // the row reaches this phase through its tap y0 + d*i + ey with
      // ey = (py - y0) mod d in {0, 1}, and likewise in x
      const int ey = ((py - y0) % d + d) % d;
      const int ex = ((px - x0) % d + d) % d;
      const int by = (y0 + ey - py) / d;  // >= 0: y0 + ey >= py
      const int bx = (x0 + ex - px) / d;
      const float fy = fracs[2 * r];
      const float fx = fracs[2 * r + 1];
      s_by[threadIdx.x] = by;
      s_bx[threadIdx.x] = bx;
      s_wy[threadIdx.x] = ey ? fy : 1.0f - fy;
      s_wx[threadIdx.x] = ex ? fx : 1.0f - fx;
      hit = ey <= 1 && ex <= 1 && by < oy0 + kTileRows && by + side > oy0 &&
            bx < ox0 + kTileCols && bx + side > ox0;
    }
    // the rows that meet the tile, compacted in row order
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int n = 0;
    for (int w = 0; w < kWarps; ++w) {
      offset += (w < warp) ? s_count[w] : 0;
      n += s_count[w];
    }
    if (hit) {
      s_hits[offset + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
    }
    __syncthreads();
    constexpr int kStep = kThreads / kTileCols;  // 8 phase rows
    for (int h = 0; h < n; ++h) {
      const int j = s_hits[h];
      const int x = ox - s_bx[j];       // the entries' window column
      const int y = oy - s_by[j];       // and window rows y, y + 8
      const float wx = s_wx[j];
      const float wy = s_wy[j];
      const In* dw = dout + static_cast<size_t>(c + j) * side * side;
      const bool x_in = static_cast<unsigned>(x) < static_cast<unsigned>(side);
      const float v0 =
          (x_in && static_cast<unsigned>(y) < static_cast<unsigned>(side))
              ? load(dw + y * side + x) : 0.0f;
      const float v1 =
          (x_in && static_cast<unsigned>(y + kStep) <
                       static_cast<unsigned>(side))
              ? load(dw + (y + kStep) * side + x) : 0.0f;
      acc[0] += (v0 * wx) * wy;
      acc[1] += (v1 * wx) * wy;
    }
  }
  float* out = partial + static_cast<size_t>(g) * tn_rows * tn_cols;
  const int b = px + d * ox;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int a = py + d * (oy + e * (kThreads / kTileCols));
    if (a < tn_rows && b < tn_cols) {
      out[static_cast<size_t>(a) * tn_cols + b] = acc[e];
    }
  }
}

template <typename In>
cudaError_t launch(const float* table, int tn_rows, int tn_cols,
                   const int* taps, const float* fracs, const void* dout,
                   float* dtable, float* dfracs, float* partial, int rows,
                   int side, int d, int groups, cudaStream_t s) {
  const In* dw = static_cast<const In*>(dout);
  strided_dshift_kernel<<<rows, kThreads, 0, s>>>(
      table, tn_rows, tn_cols, taps, fracs, dw, dfracs, side, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rn_rows = (tn_rows + d - 1) / d;  // phase rows and columns
  const int rn_cols = (tn_cols + d - 1) / d;
  const dim3 grid((rn_cols + kTileCols - 1) / kTileCols,
                  (rn_rows + kTileRows - 1) / kTileRows, d * d * groups);
  strided_dtable_kernel<<<grid, kThreads, 0, s>>>(
      taps, fracs, dw, partial, tn_rows, tn_cols, rows,
      (rows + groups - 1) / groups, side, d, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return static_cast<cudaError_t>(
      sum_partials(partial, groups, tn_rows * tn_cols, dtable, s));
}

}  // namespace

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0), fracs
// [rows, 2] f32 (fy, fx), dout [rows, side, side] f32 (bf16 with
// dout_bf16) -> dtable [tn_rows, tn_cols] f32 and dfracs [rows, 2] f32
// (dfy, dfx), at lattice divisor d >= 2.  partial is scratch of groups *
// tn_rows * tn_cols f32: the rows split into that many groups, the
// dtable kernel's grid has one layer per group, and the layers' partial
// tables are summed in group order.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int dmlt_cpb_table_strided_bwd(const void* table, int tn_rows,
                                          int tn_cols, const void* taps,
                                          const void* fracs, const void* dout,
                                          int dout_bf16, void* dtable,
                                          void* dfracs, void* partial,
                                          int rows, int side, int d,
                                          int groups, void* stream) {
  if (rows == 0 || groups < 1) return 0;
  const auto go = dout_bf16 ? launch<__nv_bfloat16> : launch<float>;
  return static_cast<int>(go(
      static_cast<const float*>(table), tn_rows, tn_cols,
      static_cast<const int*>(taps), static_cast<const float*>(fracs), dout,
      static_cast<float*>(dtable), static_cast<float*>(dfracs),
      static_cast<float*>(partial), rows, side, d, groups,
      static_cast<cudaStream_t>(stream)));
}
