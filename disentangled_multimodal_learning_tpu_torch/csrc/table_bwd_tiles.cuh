// The backward of the table CPB, shared by K1-bwd (cpb_table_bwd.cu,
// divisor 1) and K5-bwd (cpb_table_strided_bwd.cu, divisor d >= 2).
//
// What it computes: for every row r of R rows, with taps (y0, x0),
// fractions (fy, fx) (g = 1 - f) and window cotangent dw [side, side], the
// table cotangent dT [tn_rows, tn_cols] and the shift cotangents
// (dfy, dfx) of the forward's bilinear windows.
//   divisor 1 (cpb_table.cu: out = x-blend(y-blend(W)), W = T[y0.., x0..]):
//     m(y, x')  = dw(y, x') gx + dw(y, x'-1) fx              x' in [0, side]
//     dT[y0+y', x0+x'] += m(y', x') gy + m(y'-1, x') fy      y' in [0, side]
//     dfy = sum m(y, x') (W[y+1, x'] - W[y, x'])
//     dfx = sum dw(y, x) ((W[y, x+1] - W[y, x]) gy + (W[y+1, x+1] - W[y+1, x]) fy)
//   divisor d >= 2 (cpb_table_strided.cu), taps wYX = T[y0+d*i+Y, x0+d*j+X]:
//     dT[y0+d*i+Y, x0+d*j+X] += dw(i, j) (X ? fx : gx) (Y ? fy : gy)
//     dfx = sum dw(i, j) ((w01 - w00) gy + (w11 - w10) fy)
//     dfy = sum dw(i, j) ((w10 - w00) gx + (w11 - w01) fx)
// Out-of-range terms are zero.  d/dfx (and at d >= 2 d/dfy) is a blend of
// differences of neighbouring table entries, which subtract exactly: the
// blended values are O(1) and their difference O(h), so subtracting two
// blends would leave their rounding relative to O(h).  A clipped row
// (fraction outside [0, 1]) keeps the cotangent of its extrapolation.
//
// What bounds it on the card: reading the window cotangent, 46 MB at
// R = 4608, side 50 in f32 (23 MB in bf16), counted from the shapes.
//
// Design: owner computes, on tiles of the full table, with the addition
// order fixed by the launch shape.  A block owns a tile of the table and
// one group of consecutive rows; its threads own the tile's entries, each
// one column (lane) and `S` rows (its strip) of one phase (py, px) of the
// table (entries T[py + d*oy, px + d*ox]; at divisor 1 the one phase is
// the table).  A warp takes one strip of one phase, 32 columns wide (at
// divisor 1 lane 0 reads the column left of the tile, the halo of m, and
// owns no entry: 31).  The block first lists, in shared memory and in row
// order, its group's rows whose window meets the tile.  Then each warp,
// with no block barrier, takes the listed rows that reach its entries (at
// d >= 2 a phase is reached through the tap (Y, X) = ((py - y0) mod d,
// (px - x0) mod d) when both are 0 or 1), in row order, U at a time: it
// reads the part of each row's dw that maps onto its entries (at divisor 1
// one row more above, the left neighbour from the next lane by shuffle),
// with all U rows' reads in flight before their terms are added, and adds
// each entry's term to a register.  So each entry's sum over the group's
// rows is one register in one thread, in row order, with no atomics.  A
// window spans about two tiles a side, so dw is read from device memory
// about once (at d >= 2 the four phases a row reaches in a tile are four
// warps of one block, which read the same lines, the later ones from L1).
//
// The shift sums are per-row sums over the window.  Each of their terms
// goes to the entries it is indexed by, so to threads that keep the table
// differences they need in registers: at divisor 1 the whole term to the
// entry (y0+y, x0+x') of m and dw; at d >= 2 the tap w00's phase holds
// dx(w00) gy and dy(w00) gx of a window point, w10's dx(w10) fy and w01's
// dy(w01) fx (dx, dy: the differences to the next table entry in x and y).
// A warp sums its row's terms by shuffle (a fixed tree), the block adds
// its warps' sums in warp order and writes one (dfy, dfx) pair per (row,
// tile) the row meets.  The finishing kernel adds each entry's group
// partials in group order and each row's pairs over its tiles in a fixed
// lane order and tree.  So two runs on the same inputs give bitwise-equal
// results.  The sums cancel heavily (terms O(1), result O(1e-2), the
// _tbl_sum2d note), so everything stays in f32 with no fast-math.  A bf16
// window cotangent (cpb_table_bf16) is upcast as it is read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;   // a block's warps (phases x strips)
// rows a warp has in flight (read, then summed): four at divisor 1, two at
// d >= 2, where a row's strip is twice as tall (8 reads a lane)
constexpr int kRowsD1 = 4;
constexpr int kRowsStrided = 2;
constexpr int kMaxRows = 512;   // rows of a group (what a block lists)
constexpr int kFinishThreads = 256;

// The launch's geometry: ops/cpb.py table_bwd_plan, restated here from
// the four numbers the wrapper passes (strip, warps per phase, phases per
// block, row groups).
struct TilePlan {
  int tn_rows, tn_cols, rows, side, d;
  int wpp;            // warps (strips) per phase
  int phases;         // phases per block
  int groups;         // row groups
  int rows_per_group;
  int tile_h, tile_w; // a block's tile of the table
  int tiles_y, tiles_x;
  int nz;             // blocks per tile (the phases split over them)
  int reach;          // table lines a window spans
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename In>
__device__ __forceinline__ float dw_at(const In* dw, int i) {
  return load(dw + i);
}

// The tap as the forward clamps it, so a bad tap cannot read out of bounds.
__device__ __forceinline__ int clamp_tap(int t, int tn, int reach) {
  return min(max(t, 0), tn - reach);
}

// Whether the window at (y0, x0) meets tile (ty, tx).
__device__ __forceinline__ bool tile_meets(const TilePlan& p, int y0, int x0,
                                           int ty, int tx) {
  return y0 < (ty + 1) * p.tile_h && y0 + p.reach > ty * p.tile_h &&
         x0 < (tx + 1) * p.tile_w && x0 + p.reach > tx * p.tile_w;
}

__device__ __forceinline__ float table_at(const float* t, const TilePlan& p,
                                          int a, int b) {
  return (a < p.tn_rows && b < p.tn_cols)
             ? __ldg(t + static_cast<size_t>(a) * p.tn_cols + b) : 0.0f;
}

// (a, b) summed over the warp in a fixed tree: the sum of a in lane 0,
// that of b in lane 16 (one exchange splits the pair between the
// half-warps, then each half sums its value).
__device__ __forceinline__ float warp_pair_sum(float a, float b) {
  const bool hi = threadIdx.x & 16;
  float keep = hi ? b : a;
  keep += __shfl_xor_sync(0xffffffffu, hi ? a : b, 16);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    keep += __shfl_xor_sync(0xffffffffu, keep, off);
  }
  return keep;
}

// What a warp needs of one row, worked out by the lane that looked at the
// row and handed to the warp by shuffle.  Divisor 1: i = the window row of
// the strip's m row above it, j = the window column of lane 0, f = (fy,
// fx).  d >= 2: i = the window row of the strip's first entry, j = that
// of lane 0's column, f = the row's weights on the warp's phase (wy, wx),
// code bit 0: the phase holds d/dfx terms (X = 0), bit 1: d/dfy (Y = 0).
struct RowArgs {
  int i, j, code;
  float f0, f1;
};

__device__ __forceinline__ RowArgs shfl_args(const RowArgs& a, int l) {
  return {__shfl_sync(0xffffffffu, a.i, l), __shfl_sync(0xffffffffu, a.j, l),
          __shfl_sync(0xffffffffu, a.code, l),
          __shfl_sync(0xffffffffu, a.f0, l), __shfl_sync(0xffffffffu, a.f1, l)};
}

// grid (tiles_x, tiles_y, groups * nz), phases * wpp warps: block (tx, ty,
// g * nz + z) takes tile (ty, tx), phases [z * phases, (z + 1) * phases)
// and the rows of group g.  Writes the group's partial table cotangent
// (every entry of the tile) and one (dfy, dfx) pair per (row, tile) the
// row meets.
template <typename In, int S, bool kD1>
__global__ void __launch_bounds__(kD1 ? 256 : 512, kD1 ? 4 : 2)
table_bwd_tile_kernel(const float* __restrict__ table,
                      const int* __restrict__ taps,
                      const float* __restrict__ fracs,
                      const In* __restrict__ dout,
                      float* __restrict__ partial, float* __restrict__ dpart,
                      const TilePlan p) {
  constexpr int NV = kD1 ? S + 1 : S;  // dw values a lane reads per row
  constexpr int U = kD1 ? kRowsD1 : kRowsStrided;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // the group's rows that meet the tile, in row order: their taps as
  // multiples of d and remainders, fractions, indices, and each warp's
  // shift sums of each (table_bwd_smem)
  extern __shared__ int4 s_tap[];
  float2* s_frac = reinterpret_cast<float2*>(s_tap + p.rows_per_group);
  int* s_row = reinterpret_cast<int*>(s_frac + p.rows_per_group);
  float* s_red = reinterpret_cast<float*>(s_row + p.rows_per_group);
  __shared__ int s_count[kMaxWarps];
  const int d = p.d;
  const int side = p.side;
  const int zi = blockIdx.z % p.nz;
  const int g = blockIdx.z / p.nz;
  const int ph = zi * p.phases + warp / p.wpp;
  const bool live = ph < d * d;
  const int py = live ? ph / d : 0;
  const int px = live ? ph - py * d : 0;
  const int ty0 = blockIdx.y * p.tile_h;
  const int tx0 = blockIdx.x * p.tile_w;
  // the thread's column; at divisor 1 lane 0 holds the column left of the
  // tile (the halo of m) and no entry
  const int b = tx0 + px + d * lane - (kD1 ? 1 : 0);
  const bool owner = live && !(kD1 && lane == 0);
  const int a0 = ty0 + py + d * (warp % p.wpp) * S;   // rows a0 + d*k

  // the differences to the next entry in x and in y of the thread's
  // entries (at divisor 1 one row more), for its shift terms; an entry
  // past the table reads as 0 (no window term needs one)
  float dx[NV], dy[S];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int a = a0 + d * k;
    const float w = owner ? table_at(table, p, a, b) : 0.0f;
    dx[k] = owner ? table_at(table, p, a, b + 1) - w : 0.0f;
    if (k < S) dy[k] = owner ? table_at(table, p, a + 1, b) - w : 0.0f;
  }

  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = 0.0f;

  // one row's dw values at the thread's entries (divisor 1: its column,
  // window rows q.i .. q.i + S), or zeros for a row that is not there
  auto fetch = [&](const In* dw, const RowArgs& q, bool valid,
                   float (&v)[NV]) {
    const int j = q.j + lane;
    const bool jin = valid && static_cast<unsigned>(j) <
                                  static_cast<unsigned>(side);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const bool in = static_cast<unsigned>(q.i + k) <
                      static_cast<unsigned>(side);
      v[k] = (in && jin) ? dw_at(dw, (q.i + k) * side + j) : 0.0f;
    }
  };
  // its terms into the entries' sums, and its shift terms, summed over the
  // warp, into s_red[slot].  At divisor 1 with no branch (a row that is not
  // there adds zeros), so that the compiler interleaves the U rows
  auto apply = [&](const RowArgs& q, const float (&v)[NV], int slot,
                   bool valid) {
    float sy = 0.0f;
    float sx = 0.0f;
    bool holds = valid;  // whether the warp holds shift terms of the row
    if constexpr (kD1) {
      const float fy = q.f0, fx = q.f1;
      const float gy = 1.0f - fy, gx = 1.0f - fx;
      float m[S + 1];
#pragma unroll
      for (int k = 0; k <= S; ++k) {
        // lane 0 holds no entry: its m is never used
        m[k] = v[k] * gx + __shfl_up_sync(0xffffffffu, v[k], 1) * fx;
      }
#pragma unroll
      for (int k = 0; k < S; ++k) {
        acc[k] += m[k + 1] * gy + m[k] * fy;
        sy += m[k + 1] * dy[k];
        sx += v[k + 1] * (dx[k] * gy + dx[k + 1] * fy);
      }
    } else if (valid) {
#pragma unroll
      for (int k = 0; k < S; ++k) acc[k] += (v[k] * q.f1) * q.f0;
      // the tap w00's phase holds dx * gy and dy * gx of a term, w10's
      // dx * fy, w01's dy * fx: each factor is the row's weight on the
      // phase, the other one's
      holds = q.code != 0;
      if (q.code & 1) {
#pragma unroll
        for (int k = 0; k < S; ++k) sx += v[k] * dx[k];
        sx *= q.f0;
      }
      if (q.code & 2) {
#pragma unroll
        for (int k = 0; k < S; ++k) sy += v[k] * dy[k];
        sy *= q.f1;
      }
    }
    if (kD1 || holds) {
      const float sum = warp_pair_sum(sy, sx);
      if (holds && (lane & 15) == 0) {
        s_red[(slot * nwarps + warp) * 2 + (lane >> 4)] = sum;
      }
    }
  };

  const int tile = (zi * p.tiles_y + blockIdx.y) * p.tiles_x + blockIdx.x;
  const int ntiles = p.nz * p.tiles_y * p.tiles_x;
  const int r_begin = g * p.rows_per_group;
  const int r_end = min(p.rows, r_begin + p.rows_per_group);
  int n = 0;
  for (int base = r_begin; base < r_end; base += blockDim.x) {
    const int r = base + threadIdx.x;
    int hit = 0;
    int4 tap = make_int4(0, 0, 0, 0);
    float2 frac = make_float2(0.0f, 0.0f);
    if (r < r_end) {
      const int y0 = clamp_tap(taps[2 * r], p.tn_rows, p.reach);
      const int x0 = clamp_tap(taps[2 * r + 1], p.tn_cols, p.reach);
      hit = tile_meets(p, y0, x0, blockIdx.y, blockIdx.x);
      tap = make_int4(y0 / d, y0 % d, x0 / d, x0 % d);
      frac = make_float2(fracs[2 * r], fracs[2 * r + 1]);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < nwarps; ++w) {
      before += (w < warp) ? s_count[w] : 0;
      total += s_count[w];
    }
    if (hit) {
      const int h = n + before + __popc(ballot & ((1u << lane) - 1u));
      s_row[h] = r;
      s_tap[h] = tap;
      s_frac[h] = frac;
    }
    n += total;
    __syncthreads();  // s_count is read before it is written again
  }
  for (int i = threadIdx.x; i < n * nwarps * 2; i += blockDim.x) {
    s_red[i] = 0.0f;
  }
  __syncthreads();
  for (int h0 = 0; h0 < n; h0 += 32) {
    // each lane looks at one listed row; the warp then takes the rows
    // that reach its entries, in row order, U at a time (all U rows' reads
    // in flight before their terms are summed)
    const int h = h0 + lane;
    RowArgs args{0, 0, 0, 0.0f, 0.0f};
    bool active = false;
    if (live && h < n) {
      const int4 t = s_tap[h];  // (y0 / d, y0 % d, x0 / d, x0 % d)
      const float2 f = s_frac[h];
      if constexpr (kD1) {
        args = {a0 - 1 - t.x, tx0 - 1 - t.z, 0, f.x, f.y};
        active = a0 <= t.x + side && a0 + S > t.x;
      } else {
        const int Y = py - t.y + (py < t.y ? d : 0);  // (py - y0) mod d
        const int X = px - t.w + (px < t.w ? d : 0);
        args = {ty0 / d + (warp % p.wpp) * S - t.x - (py < t.y),
                tx0 / d - t.z - (px < t.w), (X == 0) | ((Y == 0) << 1),
                Y ? f.x : 1.0f - f.x, X ? f.y : 1.0f - f.y};
        active = Y <= 1 && X <= 1 && args.i < side && args.i + S > 0 &&
                 args.j < side && args.j + 32 > 0;
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, active);
    while (todo) {
      RowArgs q[U];
      int slot[U];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        valid[u] = todo != 0;
        const int l = valid[u] ? __ffs(todo) - 1 : 0;
        todo &= todo - 1;
        q[u] = shfl_args(args, l);
        slot[u] = h0 + l;
      }
      const size_t n2 = static_cast<size_t>(side) * side;
      float v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        fetch(dout + s_row[slot[u]] * n2, q[u], valid[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) apply(q[u], v[u], slot[u], valid[u]);
    }
  }
  __syncthreads();
  // the listed rows' shift sums over the block's warps, in warp order
  for (int h = threadIdx.x; h < n; h += blockDim.x) {
    float sy = 0.0f;
    float sx = 0.0f;
    for (int w = 0; w < nwarps; ++w) {
      sy += s_red[(h * nwarps + w) * 2];
      sx += s_red[(h * nwarps + w) * 2 + 1];
    }
    float* out = dpart + (static_cast<size_t>(s_row[h]) * ntiles + tile) * 2;
    out[0] = sy;
    out[1] = sx;
  }
  if (!owner || b >= p.tn_cols) return;
  float* out = partial + static_cast<size_t>(g) * p.tn_rows * p.tn_cols;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int a = a0 + d * k;
    if (a < p.tn_rows) out[static_cast<size_t>(a) * p.tn_cols + b] = acc[k];
  }
}

// Blocks [0, table_blocks): dtable[e] = the groups' partials of entry e,
// in group order.  The rest, one warp per row: dfracs[r] = the row's
// (dfy, dfx) pairs over the tiles its window meets (the tiles whose blocks
// wrote them), lane t taking the tiles t, t + 32, ... in (z, ty, tx)
// order, then the lanes' sums in a fixed tree.
__global__ void __launch_bounds__(kFinishThreads)
table_bwd_finish_kernel(const float* __restrict__ partial,
                        const float* __restrict__ dpart,
                        const int* __restrict__ taps,
                        float* __restrict__ dtable,
                        float* __restrict__ dfracs, const TilePlan p,
                        int table_blocks) {
  if (static_cast<int>(blockIdx.x) < table_blocks) {
    const int n = p.tn_rows * p.tn_cols;
    const int i = blockIdx.x * kFinishThreads + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
#pragma unroll 8
    for (int g = 0; g < p.groups; ++g) s += partial[static_cast<size_t>(g) * n + i];
    dtable[i] = s;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int r = (blockIdx.x - table_blocks) * (kFinishThreads / 32) +
                (threadIdx.x >> 5);
  if (r >= p.rows) return;
  const int y0 = clamp_tap(taps[2 * r], p.tn_rows, p.reach);
  const int x0 = clamp_tap(taps[2 * r + 1], p.tn_cols, p.reach);
  const int ty = y0 / p.tile_h;
  const int tx = x0 / p.tile_w;
  const int ny = (y0 + p.reach - 1) / p.tile_h - ty + 1;
  const int nx = (x0 + p.reach - 1) / p.tile_w - tx + 1;
  const float* q = dpart + static_cast<size_t>(r) * p.nz * p.tiles_y *
                               p.tiles_x * 2;
  float sy = 0.0f;
  float sx = 0.0f;
  for (int t = lane; t < p.nz * ny * nx; t += 32) {
    const int z = t / (ny * nx);
    const int iy = (t - z * ny * nx) / nx;
    const int ix = t - z * ny * nx - iy * nx;
    const int k = (z * p.tiles_y + ty + iy) * p.tiles_x + tx + ix;
    sy += q[2 * k];
    sx += q[2 * k + 1];
  }
  const float sum = warp_pair_sum(sy, sx);
  if ((lane & 15) == 0) dfracs[2 * r + (lane >> 4)] = sum;
}

inline int finish(const float* partial, const float* dpart, const int* taps,
                  float* dtable, float* dfracs, const TilePlan& p,
                  cudaStream_t s) {
  const int table_blocks =
      (p.tn_rows * p.tn_cols + kFinishThreads - 1) / kFinishThreads;
  const int row_blocks = (p.rows + kFinishThreads / 32 - 1) /
                         (kFinishThreads / 32);
  table_bwd_finish_kernel<<<table_blocks + row_blocks, kFinishThreads, 0, s>>>(
      partial, dpart, taps, dtable, dfracs, p, table_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a block: the listed rows' taps, fractions
// and indices, and each warp's shift sums of each.
inline size_t table_bwd_smem(const TilePlan& p) {
  return static_cast<size_t>(p.rows_per_group) *
         (sizeof(int4) + sizeof(float2) + sizeof(int) +
          2 * sizeof(float) * p.phases * p.wpp);
}

// The plan from the wrapper's four numbers, or false if the kernels do not
// take it.
inline bool make_plan(int tn_rows, int tn_cols, int rows, int side, int d,
                      int strip, int wpp, int phases, int groups,
                      TilePlan* p) {
  if (rows < 1 || side < 1 || d < 1 || groups < 1 || wpp < 1 ||
      phases < 1 || phases > d * d || phases * wpp > kMaxWarps ||
      (d == 1 && phases * wpp * 32 > 256)) {
    return false;
  }
  p->tn_rows = tn_rows;
  p->tn_cols = tn_cols;
  p->rows = rows;
  p->side = side;
  p->d = d;
  p->wpp = wpp;
  p->phases = phases;
  p->groups = groups;
  p->rows_per_group = (rows + groups - 1) / groups;
  p->tile_h = d * strip * wpp;
  p->tile_w = d == 1 ? 31 : 32 * d;
  p->tiles_y = (tn_rows + p->tile_h - 1) / p->tile_h;
  p->tiles_x = (tn_cols + p->tile_w - 1) / p->tile_w;
  p->nz = (d * d + phases - 1) / phases;
  p->reach = d == 1 ? side + 1 : d * (side - 1) + 2;
  return tn_rows >= p->reach && tn_cols >= p->reach &&
         p->rows_per_group <= kMaxRows &&
         p->tiles_y <= 65535 && p->nz * groups <= 65535;
}

// Both kernels on stream s; returns cudaGetLastError() after the launches.
template <int S, bool kD1>
int table_bwd_tiles(const void* table, int tn_rows, int tn_cols,
                    const void* taps, const void* fracs, const void* dout,
                    int dout_bf16, void* dtable, void* dfracs, void* partial,
                    void* dpart, int rows, int side, int d, int strip, int wpp,
                    int phases, int groups, void* stream) {
  TilePlan p;
  if (strip != S || (d == 1) != kD1 ||
      !make_plan(tn_rows, tn_cols, rows, side, d, strip, wpp, phases, groups,
                 &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.tiles_x, p.tiles_y, p.nz * groups);
  const int threads = phases * wpp * 32;
  const float* t = static_cast<const float*>(table);
  const int* tp = static_cast<const int*>(taps);
  const float* f = static_cast<const float*>(fracs);
  float* part = static_cast<float*>(partial);
  float* dp = static_cast<float*>(dpart);
  const size_t smem = table_bwd_smem(p);
  cudaError_t err;
  if (dout_bf16) {
    auto* kernel = table_bwd_tile_kernel<__nv_bfloat16, S, kD1>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, s>>>(
        t, tp, f, static_cast<const __nv_bfloat16*>(dout), part, dp, p);
  } else {
    auto* kernel = table_bwd_tile_kernel<float, S, kD1>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, s>>>(t, tp, f,
                                        static_cast<const float*>(dout), part,
                                        dp, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(part, dp, tp, static_cast<float*>(dtable),
                static_cast<float*>(dfracs), p, s);
}

}  // namespace
