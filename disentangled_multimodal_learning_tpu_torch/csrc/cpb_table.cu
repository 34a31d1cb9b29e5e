// K1-fwd: divisor-1 table-interpolated CPB bias windows.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_d1_fwd_kernel (the TPU kernel behind cpb_bias_table at divisor 1,
// called through _tbl_interp_call / _table_interp).
//
// What it computes: for every (bh, k) row r of R rows, the [side, side]
// bias window
//     ty(y, x)  = T[y0+y, x0+x] * (1-fy) + T[y0+y+1, x0+x] * fy
//     out(y, x) = ty(y, x) * (1-fx) + ty(y, x+1) * fx
// of the MLP table T [tn_rows, tn_cols], at the row's integer taps
// (y0, x0) and fractions (fy, fx).  The y-blend comes first, then the
// x-blend, as in the TPU kernel.  Taps and fractions come from
// ops/cpb.py table_taps (the port of _tbl_idx at divisor 1); a clipped row
// has a fraction outside [0, 1] and extrapolates, exactly as on the TPU.
//
// What bounds it on the card: the output write.  At production shapes
// (R = 4608, side = 50) a call reads a 139 x 139 f32 table (77 KB, counted
// from the shapes, small enough to stay in L2) and writes R * side^2 f32
// values (46 MB), at ~2 flops per output byte.
//
// What the design does about that: one block per row stages the row's
// (side+1)^2 window (51^2 f32 at side 50) in shared memory once, so every
// table value is read from L2 once per row, and each thread then writes
// consecutive outputs, so a warp stores 128 contiguous bytes.  No layout
// tricks of the TPU kernel (8-aligned sublane windows, lane rolls, the
// lane-split two-copy table) are needed: the window is addressed directly.
// Every product and sum is rounded separately (__fmul_rn / __fadd_rn), so
// the result is bitwise that of the plain PyTorch version
// (ops/cpb.py table_interp_reference), which rounds each op the same way.
// Under cpb_table_bf16 (the TPU's TBL_BF16_OUT) the blend stays f32 and
// only the store rounds to bf16 (round to nearest even, as the plain
// version's .to(torch.bfloat16)), halving the write.

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
cpb_table_interp_fwd_kernel(const float* __restrict__ table, int tn_rows,
                            int tn_cols, const int* __restrict__ taps,
                            const float* __restrict__ fracs,
                            Out* __restrict__ out, int side) {
  extern __shared__ float win[];  // (side + 1) x (side + 1), row-major
  const int r = blockIdx.x;
  const int w = side + 1;
  // The taps are clipped on the host side so that the window lies inside
  // the table; clamping again keeps a bad tap from reading out of bounds.
  const int y0 = min(max(taps[2 * r], 0), tn_rows - w);
  const int x0 = min(max(taps[2 * r + 1], 0), tn_cols - w);
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int y = i / w;
    const int x = i - y * w;
    win[i] = table[static_cast<size_t>(y0 + y) * tn_cols + x0 + x];
  }
  __syncthreads();

  const float fy = fracs[2 * r];
  const float fx = fracs[2 * r + 1];
  const float gy = __fsub_rn(1.0f, fy);
  const float gx = __fsub_rn(1.0f, fx);
  Out* o = out + static_cast<size_t>(r) * side * side;
  for (int i = threadIdx.x; i < side * side; i += blockDim.x) {
    const int y = i / side;
    const int x = i - y * side;
    const float* t = win + y * w + x;
    const float a = __fadd_rn(__fmul_rn(t[0], gy), __fmul_rn(t[w], fy));
    const float b = __fadd_rn(__fmul_rn(t[1], gy), __fmul_rn(t[w + 1], fy));
    store(o + i, __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx)));
  }
}

}  // namespace

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0),
// fracs [rows, 2] f32 (fy, fx) -> out [rows, side, side], f32 or, with
// out_bf16, bf16.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int dmlt_cpb_table_interp_fwd(const void* table, int tn_rows,
                                         int tn_cols, const void* taps,
                                         const void* fracs, void* out,
                                         int out_bf16, int rows, int side,
                                         void* stream) {
  if (rows == 0) return 0;
  const size_t smem = static_cast<size_t>(side + 1) * (side + 1) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* tp = static_cast<const int*>(taps);
  const float* f = static_cast<const float*>(fracs);
  if (out_bf16) {
    cpb_table_interp_fwd_kernel<<<rows, kThreads, smem, s>>>(
        t, tn_rows, tn_cols, tp, f, static_cast<__nv_bfloat16*>(out), side);
  } else {
    cpb_table_interp_fwd_kernel<<<rows, kThreads, smem, s>>>(
        t, tn_rows, tn_cols, tp, f, static_cast<float*>(out), side);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dmlt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
