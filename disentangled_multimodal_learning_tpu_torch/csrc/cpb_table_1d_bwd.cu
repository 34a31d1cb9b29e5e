// K4-bwd: gradient of the 1-D table-interpolated CPB bias.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl1_bwd_kernel (the TPU kernel behind the custom VJP of _table1_interp,
// _tbl1_vjp_bwd) and its [rows, 128] layout variant _tbl1w_bwd_kernel.
//
// What it computes: with the forward of cpb_table_1d.cu,
// out[bg, c, k, n] = T[c, ox+n] * (1-f) + T[c, ox+n+1] * f for row
// r = bg * kv + k, and the bias cotangent d [B*G, n_out, K, n_q] in that
// layout,
//     dT[c, ox+n] += d[r, c, n] * (1-f) + d[r, c, n-1] * f   n in [0, n_q]
//     dshift[r]    = sum_c sum_n d[r, c, n] * (T[c, ox+n+1] - T[c, ox+n])
// (out-of-range d terms are zero).  A clipped row (f outside [0, 1])
// extrapolates in the forward, and its shift cotangent is that of the
// extrapolation: nothing is masked, as in the TPU kernel.
//
// What bounds it on the card: reading the bias cotangent once.  At the
// deformpathomic preset (R = 10,000 rows, n_out = 2, n_q = 2501, tn ~ 5k)
// that is 200 MB; every row scatters 2 x 2502 values into one 2 x tn table,
// ~4,000 contributions per table entry.
//
// Design: owner computes, on tiles of the table (the 1-D form of
// table_bwd_tiles.cuh), with the order of every addition fixed by the
// launch shape.  A block owns a tile of kTile consecutive entries of one
// channel and one group of consecutive rows.  Each warp owns 32 * kStrip
// consecutive entries of the tile: lane j the entries j, j + 32, ... of its
// strips.  The block first lists, in shared memory and in row order, its
// group's rows whose window [ox, ox + n_q] meets the tile.  Then each warp,
// with no block barrier, takes the listed rows that reach its entries, in
// row order, kRows at a time: it reads each row's d at its entries
// (d[e - ox] for entry e; 128 coalesced bytes a warp and strip), with all
// kRows rows' reads in flight before their terms are added, takes
// d[e - ox - 1] from the lane below by shuffle (lane 0 from lane 31 of the
// strip below, or, for the warp's first strip, by one more read: the halo),
// and adds its entries' terms to registers.  So each entry's sum over a
// group's rows is one register in one thread, in row order, with no
// atomics and no table copy in shared memory: the table may be any size.
// A window spans about n_q / kTile + 1 tiles, so d is read from device
// memory once (the halo, one value a warp and row, twice).
//
// The shift sums are per-row sums over the window.  The term of query n
// goes to the thread that owns entry ox + n, which keeps its entries'
// differences T[e+1] - T[e] in registers (neighbouring entries subtract
// exactly; the sums cancel, terms O(1) and results much smaller).  A warp
// sums its kRows rows' terms by shuffle in one fixed tree, the block adds
// its warps' sums in warp order and writes one partial per (row, tile) the
// row meets.  The finishing kernel adds each entry's group partials in a
// fixed order (kSlices strided runs of groups, then the runs in order) and
// each row's partials over the tiles of both channels, channel by channel,
// tile by tile.  So two runs on the same inputs give bitwise-equal results;
// everything stays in f32 with no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 4;                  // entries a lane owns
constexpr int kRows = 4;                   // rows a warp has in flight
constexpr int kTile = 32 * kStrip * kWarps;  // a block's entries: 1024
constexpr int kMaxRows = 1024;             // rows of a group (what a block lists)
constexpr int kFinishThreads = 256;
constexpr int kSlices = kFinishThreads / 32;  // strided runs of the groups

// The launch's geometry: ops/cpb1d.py table1d_bwd_plan, restated here from
// the shapes and the row-group count the wrapper passes.
struct Plan1d {
  int n_out, tn, rows, kv, n_q;
  int groups, rows_per_group;
  int tiles_c;  // tiles of one channel
};

// The tap as the forward clamps it, so a bad tap cannot read out of bounds.
__device__ __forceinline__ int clamp_tap(int t, const Plan1d& p) {
  return min(max(t, 0), p.tn - p.n_q - 1);
}

// x[u] summed over the warp for each of the U rows in one fixed tree: each
// exchange hands half the rows to the other half of the warp, then each
// lane group sums its row.  Row u's sum ends in lane u * (32 / U).
template <int U>
__device__ __forceinline__ float warp_sum_rows(float (&x)[U], int lane) {
  static_assert(U >= 1 && U <= 32 && (U & (U - 1)) == 0, "U a power of 2");
  int off = 16;
#pragma unroll
  for (int cnt = U; cnt > 1; cnt >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < cnt / 2; ++i) {
      const float keep = up ? x[i + cnt / 2] : x[i];
      const float send = up ? x[i] : x[i + cnt / 2];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float s = x[0];
#pragma unroll
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// grid (n_out * tiles_c, groups), kThreads threads: block (c * tiles_c + t,
// g) takes entries [t * kTile, (t + 1) * kTile) of channel c and the rows
// of group g.  Writes the group's partial table cotangent (every entry of
// the tile) and one shift partial per (row, tile) the row meets.
__global__ void __launch_bounds__(kThreads, 4)
table1d_bwd_tile_kernel(const float* __restrict__ table,
                        const int* __restrict__ taps,
                        const float* __restrict__ fracs,
                        const float* __restrict__ dout,
                        float* __restrict__ partial,
                        float* __restrict__ dpart, const Plan1d p) {
  // the group's rows that meet the tile, in row order: where their d
  // segment of this channel lies (minus the tap), their taps, fractions
  // and indices, and each warp's shift sums of each (table1d_bwd_smem)
  extern __shared__ long long s_seg[];
  int* s_ox = reinterpret_cast<int*>(s_seg + p.rows_per_group);
  float* s_f = reinterpret_cast<float*>(s_ox + p.rows_per_group);
  int* s_row = reinterpret_cast<int*>(s_f + p.rows_per_group);
  float* s_red = reinterpret_cast<float*>(s_row + p.rows_per_group);
  __shared__ int s_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int c = tile / p.tiles_c;
  const int t0 = (tile - c * p.tiles_c) * kTile;
  const int g = blockIdx.y;
  const int wb = t0 + warp * 32 * kStrip;  // the warp's first entry
  const float* T = table + static_cast<size_t>(c) * p.tn;

  // the differences to the next entry of the thread's entries, for its
  // shift terms (an entry past the table, or the last, takes no term)
  float diff[kStrip], acc[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int e = wb + 32 * s + lane;
    diff[s] = e + 1 < p.tn ? __ldg(T + e + 1) - __ldg(T + e) : 0.0f;
    acc[s] = 0.0f;
  }

  const int r_begin = g * p.rows_per_group;
  const int r_end = min(p.rows, r_begin + p.rows_per_group);
  int n = 0;
  for (int base = r_begin; base < r_end; base += kThreads) {
    const int r = base + threadIdx.x;
    int hit = 0;
    int ox = 0;
    float f = 0.0f;
    if (r < r_end) {
      ox = clamp_tap(taps[r], p);
      hit = ox < t0 + kTile && ox + p.n_q >= t0;
      f = fracs[r];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += (w < warp) ? s_count[w] : 0;
      total += s_count[w];
    }
    if (hit) {
      const int h = n + before + __popc(ballot & ((1u << lane) - 1u));
      const int bg = r / p.kv;
      s_seg[h] = ((static_cast<long long>(bg) * p.n_out + c) * p.kv +
                  (r - bg * p.kv)) * p.n_q - ox;
      s_ox[h] = ox;
      s_f[h] = f;
      s_row[h] = r;
    }
    n += total;
    __syncthreads();  // s_count is read before it is written again
  }
  for (int i = threadIdx.x; i < n * kWarps; i += kThreads) s_red[i] = 0.0f;
  __syncthreads();

  for (int h0 = 0; h0 < n; h0 += 32) {
    // each lane looks at one listed row; the warp then takes the rows
    // whose window [ox, ox + n_q] meets its entries, in row order, kRows at
    // a time (all their reads in flight before their terms are summed)
    const int h = h0 + lane;
    const bool active = h < n && s_ox[h] < wb + 32 * kStrip &&
                        s_ox[h] + p.n_q >= wb;
    unsigned todo = __ballot_sync(0xffffffffu, active);
    while (todo) {
      int hs[kRows];
      bool valid[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        valid[u] = todo != 0;
        hs[u] = h0 + (valid[u] ? __ffs(todo) - 1 : 0);
        todo &= todo - 1;
      }
      // d at the thread's entries (zero outside the window, or for a row
      // that is not there), and for lane 0 the one below the warp's first
      float v[kRows][kStrip], halo[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int ox = s_ox[hs[u]];
        const float* d = dout + s_seg[hs[u]];
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          const int e = wb + 32 * s + lane;
          v[u][s] = valid[u] && static_cast<unsigned>(e - ox) <
                                    static_cast<unsigned>(p.n_q)
                        ? __ldg(d + e) : 0.0f;
        }
        halo[u] = valid[u] && lane == 0 &&
                          static_cast<unsigned>(wb - 1 - ox) <
                              static_cast<unsigned>(p.n_q)
                      ? __ldg(d + wb - 1) : 0.0f;
      }
      float sd[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float f = valid[u] ? s_f[hs[u]] : 0.0f;
        const float gf = 1.0f - f;
        sd[u] = 0.0f;
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          const float up = __shfl_up_sync(0xffffffffu, v[u][s], 1);
          const float below =
              s == 0 ? halo[u] : __shfl_sync(0xffffffffu, v[u][s - 1], 31);
          const float prev = lane == 0 ? below : up;
          acc[s] += v[u][s] * gf + prev * f;
          sd[u] += v[u][s] * diff[s];
        }
      }
      const float sum = warp_sum_rows<kRows>(sd, lane);
      if (lane % (32 / kRows) == 0) {
        const int mine = lane / (32 / kRows);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (u == mine && valid[u]) s_red[hs[u] * kWarps + warp] = sum;
        }
      }
    }
  }
  __syncthreads();
  // the listed rows' shift sums over the block's warps, in warp order
  const int ntiles = p.n_out * p.tiles_c;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_red[i * kWarps + w];
    dpart[static_cast<size_t>(s_row[i]) * ntiles + tile] = s;
  }
  float* out = partial + (static_cast<size_t>(g) * p.n_out + c) * p.tn;
#pragma unroll
  for (int s = 0; s < kStrip; ++s) {
    const int e = wb + 32 * s + lane;
    if (e < p.tn) out[e] = acc[s];
  }
}

// Blocks [0, table_blocks), 32 entries each: dtable[i] = the groups'
// partials of entry i, warp k adding the groups k, k + kSlices, ... in
// order, then the warps' sums in warp order.  The rest, a thread per row:
// dshifts[r] = the row's partials over the tiles its window meets (the
// tiles whose blocks wrote them), channel by channel, tile by tile.
__global__ void __launch_bounds__(kFinishThreads)
table1d_bwd_finish_kernel(const float* __restrict__ partial,
                          const float* __restrict__ dpart,
                          const int* __restrict__ taps,
                          float* __restrict__ dtable,
                          float* __restrict__ dshifts, const Plan1d p,
                          int table_blocks) {
  if (static_cast<int>(blockIdx.x) < table_blocks) {
    __shared__ float s_sum[kSlices][32];
    const int lane = threadIdx.x & 31;
    const int slice = threadIdx.x >> 5;
    const int n = p.n_out * p.tn;
    const int i = blockIdx.x * 32 + lane;
    float s = 0.0f;
    if (i < n) {
#pragma unroll 4
      for (int g = slice; g < p.groups; g += kSlices) {
        s += partial[static_cast<size_t>(g) * n + i];
      }
    }
    s_sum[slice][lane] = s;
    __syncthreads();
    if (slice == 0 && i < n) {
      float t = s_sum[0][lane];
#pragma unroll
      for (int k = 1; k < kSlices; ++k) t += s_sum[k][lane];
      dtable[i] = t;
    }
    return;
  }
  const int r = (blockIdx.x - table_blocks) * kFinishThreads + threadIdx.x;
  if (r >= p.rows) return;
  const int ox = clamp_tap(taps[r], p);
  const int first = ox / kTile;
  const int last = (ox + p.n_q) / kTile;
  const float* q = dpart + static_cast<size_t>(r) * p.n_out * p.tiles_c;
  float s = 0.0f;
  for (int c = 0; c < p.n_out; ++c) {
    for (int t = first; t <= last; ++t) s += q[c * p.tiles_c + t];
  }
  dshifts[r] = s;
}

// The dynamic shared memory of a block: the listed rows' segments, taps,
// fractions and indices, and each warp's shift sums of each.
inline size_t table1d_bwd_smem(const Plan1d& p) {
  return static_cast<size_t>(p.rows_per_group) *
         (sizeof(long long) + sizeof(int) + sizeof(float) + sizeof(int) +
          sizeof(float) * kWarps);
}

}  // namespace

// table [n_out, tn] f32, taps [rows] int32, fracs [rows] f32, dout
// [rows / kv, n_out, kv, n_q] f32 -> dtable [n_out, tn] f32 and dshifts
// [rows] f32, in row groups of ceil(rows / groups) rows (ops/cpb1d.py
// table1d_bwd_plan; tiles of 1024 entries).  partial is scratch of groups *
// n_out * tn f32 and dpart of rows * n_out * ceil(tn / 1024) f32.  Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int dmlt_cpb_table_1d_bwd(const void* table, int n_out, int tn,
                                     const void* taps, const void* fracs,
                                     const void* dout, void* dtable,
                                     void* dshifts, void* partial,
                                     void* dpart, int rows, int kv, int n_q,
                                     int groups, void* stream) {
  if (rows == 0 || n_out == 0) return 0;
  Plan1d p{n_out, tn, rows, kv, n_q, groups, 0, (tn + kTile - 1) / kTile};
  if (groups < 1 || kv < 1 || n_q < 1 || tn < n_q + 2 || rows % kv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.rows_per_group = (rows + groups - 1) / groups;
  if (p.rows_per_group > kMaxRows || groups > 65535 ||
      static_cast<long long>(n_out) * p.tiles_c > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = table1d_bwd_smem(p);
  cudaError_t err = cudaFuncSetAttribute(
      table1d_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_out * p.tiles_c, groups);
  table1d_bwd_tile_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(table), static_cast<const int*>(taps),
      static_cast<const float*>(fracs), static_cast<const float*>(dout),
      static_cast<float*>(partial), static_cast<float*>(dpart), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int table_blocks = (n_out * tn + 31) / 32;
  const int row_blocks = (rows + kFinishThreads - 1) / kFinishThreads;
  table1d_bwd_finish_kernel<<<table_blocks + row_blocks, kFinishThreads, 0,
                              s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(dpart),
      static_cast<const int*>(taps), static_cast<float*>(dtable),
      static_cast<float*>(dshifts), p, table_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel's blocks an SM holds at groups of rows_per_group rows;
// 0 if the runtime refuses the shared memory.
extern "C" int dmlt_cpb_table_1d_bwd_blocks(int rows_per_group) {
  Plan1d p{};
  p.rows_per_group = rows_per_group;
  const size_t smem = table1d_bwd_smem(p);
  int per_sm = 0;
  if (cudaFuncSetAttribute(table1d_bwd_tile_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, table1d_bwd_tile_kernel, kThreads, smem) != cudaSuccess) {
    return 0;
  }
  return per_sm;
}
