// K5-fwd: table-interpolated CPB bias windows at lattice divisor d >= 2.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_fwd_kernel (the TPU kernel behind cpb_bias_table at divisor >= 2,
// called through _tbl_interp_call / _table_interp).
//
// What it computes: for every (bh, k) row r of R rows, the [side, side]
// bias window
//     a(y, x)   = T[y0+d*y, x0+d*x]   * (1-fy) + T[y0+d*y+1, x0+d*x]   * fy
//     b(y, x)   = T[y0+d*y, x0+d*x+1] * (1-fy) + T[y0+d*y+1, x0+d*x+1] * fy
//     out(y, x) = a(y, x) * (1-fx) + b(y, x) * fx
// of the MLP table T [tn, tn] on a lattice d times finer than the query
// grid, at the row's integer taps (y0, x0) and fractions (fy, fx) from
// ops/cpb.py table_taps (the port of _tbl_idx); a clipped row has a
// fraction outside [0, 1] and extrapolates, as on the TPU.  The y-blend
// comes first, then the x-blend, as in the TPU kernel.
//
// What bounds it on the card.  A call writes R * side^2 values (46 MB in
// f32, 23 MB with the bf16 store of cpb_table_bf16, at R = 4608, side =
// 50) and reads a table of 274^2 f32 (300 KB) at d = 2 or 544^2 (1.18 MB)
// at d = 4, counted from the shapes: the bytes.  No two rows share their
// taps, so each row's four taps (40 KB) come from L2: 184 MB at the
// production shapes, about four times the output, and the L2 reads set
// the pace.  Read from the table as it is, a row's taps at d = 4 are two
// of every four table columns: every 32-byte sector fetched carries half
// useful words, and the row pulls twice its taps through L1.
//
// What the design does about that: at d >= 3 a first, small kernel writes
// the x-phase planes of the table with each entry paired with its right
// neighbour, Q[px][Y][ox] = (T[Y, ox*d + px], T[Y, ox*d + px + 1]) (2.4 MB
// at d = 4, into the caller's scratch; the TPU's phase decomposition in x,
// none of its 128-lane padding).  An output's taps (y0 + d*y + ay, x0 +
// d*x + ax) are then the pairs at column x0/d + x of rows y0 + d*y and
// y0 + d*y + 1 of plane x0 % d (the tap right of phase d - 1 is phase 0
// one column on, which the pair holds), two 8-byte loads in which every
// word is a tap.  At d = 2 the taps are already two of every two table
// columns, and the table is read as it is (no first kernel).  The full
// phase planes (four taps from four planes, the TPU's layout) measured no
// faster at d = 4 and slower at d = 2 (four 4-byte streams a warp where
// the pairs need two), and a one-wave grid walking rows sorted by window
// position (to share taps in L1) lost more to its sort than L1 gave back
// (the measurements are in PERF.md, PR 12).  The main kernel takes a
// block of 128 threads a row, as many as fit an SM, so that enough rows'
// loads are in flight to keep L2 busy; thread t takes the row's outputs
// t, t + 128, ..., its (y, x) from one division and then fixed steps,
// four outputs in flight, so each load of a warp reads 32 consecutive
// pairs (or table words) of one or two window rows, and each store writes
// 32 consecutive outputs (bf16 pairs packed into 4-byte stores by a
// shuffle, and 256 threads a row, measured slower).
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn) and
// the bf16 store rounds to nearest even, so the result is bitwise that of
// the plain PyTorch version (ops/cpb.py table_interp_reference), which
// rounds each op the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;      // the block of a row
constexpr int kPairThreads = 256;  // the first kernel's block
constexpr int kPairBlocks = 528;   // its blocks, at most (four an H100 SM)

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the x-phase pair planes at divisor d (d >= 3), else none
__host__ __device__ inline bool uses_pairs(int d) { return d >= 3; }

// bytes of the scratch: the pair planes [d, tn_rows, ceil(tn_cols / d)]
// of float2 at d >= 3, none at d = 2
inline long long scratch_bytes(int tn_rows, int tn_cols, int d) {
  return uses_pairs(d) ? 8LL * d * tn_rows * cdiv(tn_cols, d) : 0;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The first kernel: Q[px][Y][ox] = (T[Y, ox*d + px], T[Y, ox*d + px + 1]),
// 0 past the table's columns (never read: the taps are clipped inside it).
__global__ void __launch_bounds__(kPairThreads)
strided_pairs_kernel(const float* __restrict__ table, int tn_rows,
                     int tn_cols, int d, float2* __restrict__ pairs) {
  const int rn_x = cdiv(tn_cols, d);
  const long long plane = static_cast<long long>(tn_rows) * rn_x;
  const long long total = plane * d;
  for (long long e = blockIdx.x * static_cast<long long>(kPairThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kPairThreads) {
    const int px = static_cast<int>(e / plane);
    const int rem = static_cast<int>(e - px * plane);
    const int y = rem / rn_x;
    const int x = (rem - y * rn_x) * d + px;
    const float* t = table + static_cast<size_t>(y) * tn_cols + x;
    pairs[e] = make_float2(x < tn_cols ? __ldg(t) : 0.0f,
                           x + 1 < tn_cols ? __ldg(t + 1) : 0.0f);
  }
}

// A row's window: its four taps at output (y, x), y-blends then the
// x-blend, each op rounded as the plain version.  kPairs: from the pair
// planes (base: the pair at the window's first row and column); else from
// the table (base: the window's first tap).
template <bool kPairs>
struct Window {
  const float* base;
  int ld;  // pairs (kPairs) or floats of a table row
  int d;
  float fy, fx, gy, gx;

  __device__ __forceinline__ float at(int y, int x) const {
    float t00, t01, t10, t11;
    if constexpr (kPairs) {
      const float2* p =
          reinterpret_cast<const float2*>(base) + d * y * ld + x;
      const float2 a = __ldg(p);
      const float2 b = __ldg(p + ld);
      t00 = a.x;
      t01 = a.y;
      t10 = b.x;
      t11 = b.y;
    } else {
      const float* p = base + d * (y * ld + x);
      t00 = __ldg(p);
      t01 = __ldg(p + 1);
      t10 = __ldg(p + ld);
      t11 = __ldg(p + ld + 1);
    }
    const float a = __fadd_rn(__fmul_rn(t00, gy), __fmul_rn(t10, fy));
    const float b = __fadd_rn(__fmul_rn(t01, gy), __fmul_rn(t11, fy));
    return __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx));
  }
};

// One row's side^2 outputs o[]: thread t takes outputs t, t + kThreads,
// ...; its first at (y, x) = t / side, t % side (the one division), the
// next each a fixed step on, four at a time in flight (the block's steps
// counted alike in every thread); each output stored alone (a warp writes
// 128 contiguous bytes in f32, 64 in bf16).
template <typename Out, bool kPairs>
__device__ __forceinline__ void write_row(Out* __restrict__ o,
                                          const Window<kPairs>& w, int side) {
  const int n = side * side;
  const int t = threadIdx.x;
  const int step_y = kThreads / side;
  const int step_x = kThreads - step_y * side;
  int y = t / side;
  int x = t - y * side;
#pragma unroll 4
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    if (i0 + t < n) store(o + i0 + t, w.at(y, x));
    x += step_x;
    y += step_y;
    if (x >= side) {
      x -= side;
      ++y;
    }
  }
}

// The main kernel: block r writes row r.
template <typename Out, bool kPairs>
__global__ void __launch_bounds__(kThreads)
strided_row_kernel(const float* __restrict__ source, int tn_rows, int tn_cols,
                   const int* __restrict__ taps,
                   const float* __restrict__ fracs, Out* __restrict__ out,
                   int side, int d) {
  const int r = blockIdx.x;
  // the taps are clipped on the host side; clamping again keeps a bad tap
  // from reading outside the table
  const int reach = d * (side - 1) + 2;
  const int y0 = min(max(__ldg(taps + 2 * r), 0), tn_rows - reach);
  const int x0 = min(max(__ldg(taps + 2 * r + 1), 0), tn_cols - reach);
  Window<kPairs> w;
  w.d = d;
  if constexpr (kPairs) {
    w.ld = cdiv(tn_cols, d);
    w.base = source + 2 * ((static_cast<size_t>(x0 % d) * tn_rows + y0) *
                               w.ld + x0 / d);
  } else {
    w.ld = tn_cols;
    w.base = source + static_cast<size_t>(y0) * tn_cols + x0;
  }
  w.fy = __ldg(fracs + 2 * r);
  w.fx = __ldg(fracs + 2 * r + 1);
  w.gy = __fsub_rn(1.0f, w.fy);
  w.gx = __fsub_rn(1.0f, w.fx);
  write_row(out + static_cast<size_t>(r) * side * side, w, side);
}

// Asks, on the first call only, for the main kernel's largest L1 (it
// keeps nothing in shared memory); the runtime's answer to that request.
template <typename Out, bool kPairs>
cudaError_t prefer_l1() {
  static const cudaError_t err = cudaFuncSetAttribute(
      strided_row_kernel<Out, kPairs>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  return err;
}

// The main kernel's blocks an SM with the largest L1; 0 if the runtime
// refuses.
template <typename Out, bool kPairs>
int blocks_per_sm() {
  int per_sm = 0;
  if (prefer_l1<Out, kPairs>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, strided_row_kernel<Out, kPairs>, kThreads, 0) !=
          cudaSuccess) {
    return 0;
  }
  return per_sm;
}

template <typename Out, bool kPairs>
int launch(const float* table, int tn_rows, int tn_cols, const int* taps,
           const float* fracs, Out* out, int rows, int side, int d,
           void* scratch, cudaStream_t s) {
  if (const cudaError_t err = prefer_l1<Out, kPairs>(); err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const float* source = table;
  if (kPairs) {
    const long long total =
        static_cast<long long>(d) * tn_rows * cdiv(tn_cols, d);
    const int blocks = static_cast<int>(
        min(static_cast<long long>(kPairBlocks),
            (total + kPairThreads - 1) / kPairThreads));
    strided_pairs_kernel<<<blocks, kPairThreads, 0, s>>>(
        table, tn_rows, tn_cols, d, static_cast<float2*>(scratch));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    source = static_cast<const float*>(scratch);
  }
  strided_row_kernel<Out, kPairs><<<rows, kThreads, 0, s>>>(
      source, tn_rows, tn_cols, taps, fracs, out, side, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int launch(const float* table, int tn_rows, int tn_cols, const int* taps,
           const float* fracs, Out* out, int rows, int side, int d,
           void* scratch, cudaStream_t s) {
  return uses_pairs(d) ? launch<Out, true>(table, tn_rows, tn_cols, taps,
                                           fracs, out, rows, side, d,
                                           scratch, s)
                       : launch<Out, false>(table, tn_rows, tn_cols, taps,
                                            fracs, out, rows, side, d,
                                            scratch, s);
}

}  // namespace

// Bytes of scratch K5-fwd needs for a [tn_rows, tn_cols] table at divisor
// d: the pair planes at d >= 3, none at d = 2.
extern "C" int dmlt_cpb_table_strided_fwd_scratch(int tn_rows, int tn_cols,
                                                  int d) {
  return static_cast<int>(scratch_bytes(tn_rows, tn_cols, d));
}

// The main kernel's blocks an SM for the store and divisor; 0 if the
// runtime refuses the launch.
extern "C" int dmlt_cpb_table_strided_fwd_blocks(int out_bf16, int d) {
  if (uses_pairs(d)) {
    return out_bf16 ? blocks_per_sm<__nv_bfloat16, true>()
                    : blocks_per_sm<float, true>();
  }
  return out_bf16 ? blocks_per_sm<__nv_bfloat16, false>()
                  : blocks_per_sm<float, false>();
}

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0), fracs
// [rows, 2] f32 (fy, fx) -> out [rows, side, side], f32 or, with out_bf16,
// bf16, at lattice divisor d >= 2; scratch: the bytes of
// dmlt_cpb_table_strided_fwd_scratch, 8-byte aligned (unused at d = 2).
// At d >= 3 two launches on the stream (the pair planes, then the
// windows).  Returns cudaGetLastError() after them (0 = launched).
extern "C" int dmlt_cpb_table_strided_fwd(const void* table, int tn_rows,
                                          int tn_cols, const void* taps,
                                          const void* fracs, void* out,
                                          int out_bf16, int rows, int side,
                                          int d, void* scratch,
                                          void* stream) {
  if (rows == 0) return 0;
  if (d < 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* tp = static_cast<const int*>(taps);
  const float* f = static_cast<const float*>(fracs);
  if (out_bf16) {
    return launch(t, tn_rows, tn_cols, tp, f,
                  static_cast<__nv_bfloat16*>(out), rows, side, d, scratch, s);
  }
  return launch(t, tn_rows, tn_cols, tp, f, static_cast<float*>(out), rows,
                side, d, scratch, s);
}
