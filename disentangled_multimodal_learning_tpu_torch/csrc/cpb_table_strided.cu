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
// comes first, then the x-blend, as in the TPU kernel.  The TPU stores the
// table phase-decomposed (rows (py*d + px)*rn + oy) so that a window's
// stride-d rows are contiguous sublanes; that is a layout of the same
// lattice, and here the strided taps are addressed directly on the full
// table.
//
// What bounds it on the card: the output write.  At production shapes
// (R = 4608, side = 50) a call writes R * side^2 f32 values (46 MB; 23 MB
// with the bf16 store of cpb_table_bf16) and reads a table of 274^2 f32
// (300 KB) at d = 2 or 544^2 (1.18 MB) at d = 4, counted from the shapes.
//
// What the design does about that: the table is too large for K1's
// shared-memory window at d = 4, and no table value is shared by two
// outputs at d >= 2 (a window's 2*side x 2*side taps are distinct), so
// staging would save no reads.  One block per row reads each output's four
// taps straight from L2, where the table stays resident, and each thread
// writes consecutive outputs, so a warp stores 128 contiguous bytes (64
// with bf16).  Every product and sum is rounded separately (__fmul_rn /
// __fadd_rn) and the bf16 store rounds to nearest even, so the result is
// bitwise that of the plain PyTorch version (ops/cpb.py
// table_interp_reference), which rounds each op the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
cpb_table_strided_fwd_kernel(const float* __restrict__ table, int tn_rows,
                             int tn_cols, const int* __restrict__ taps,
                             const float* __restrict__ fracs,
                             Out* __restrict__ out, int side, int d) {
  const int r = blockIdx.x;
  const int reach = d * (side - 1) + 2;  // lattice points a window spans
  // The taps are clipped on the host side so that the window lies inside
  // the table; clamping again keeps a bad tap from reading out of bounds.
  const int y0 = min(max(taps[2 * r], 0), tn_rows - reach);
  const int x0 = min(max(taps[2 * r + 1], 0), tn_cols - reach);
  const float fy = fracs[2 * r];
  const float fx = fracs[2 * r + 1];
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  Out* o = out + static_cast<size_t>(r) * side * side;
  for (int i = threadIdx.x; i < side * side; i += blockDim.x) {
    const int y = i / side;
    const int x = i - y * side;
    const float* t = table + static_cast<size_t>(y0 + d * y) * tn_cols +
                     x0 + d * x;
    const float a = __fadd_rn(__fmul_rn(__ldg(t), gy),
                              __fmul_rn(__ldg(t + tn_cols), fy));
    const float b = __fadd_rn(__fmul_rn(__ldg(t + 1), gy),
                              __fmul_rn(__ldg(t + tn_cols + 1), fy));
    store(o + i, __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));
  }
}

}  // namespace

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0), fracs
// [rows, 2] f32 (fy, fx) -> out [rows, side, side], f32 or, with out_bf16,
// bf16, at lattice divisor d.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int dmlt_cpb_table_strided_fwd(const void* table, int tn_rows,
                                          int tn_cols, const void* taps,
                                          const void* fracs, void* out,
                                          int out_bf16, int rows, int side,
                                          int d, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* tp = static_cast<const int*>(taps);
  const float* f = static_cast<const float*>(fracs);
  if (out_bf16) {
    cpb_table_strided_fwd_kernel<<<rows, kThreads, 0, s>>>(
        t, tn_rows, tn_cols, tp, f, static_cast<__nv_bfloat16*>(out), side,
        d);
  } else {
    cpb_table_strided_fwd_kernel<<<rows, kThreads, 0, s>>>(
        t, tn_rows, tn_cols, tp, f, static_cast<float*>(out), side, d);
  }
  return static_cast<int>(cudaGetLastError());
}
