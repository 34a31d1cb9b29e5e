// K4-fwd: 1-D table-interpolated CPB bias, written in the attention's layout.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl1_fwd_kernel (the TPU kernel behind cpb_bias_table_1d, called through
// _table1_interp) and its [rows, 128] layout variant _tbl1w_fwd_kernel,
// which compute the same function.
//
// What it computes: the MLP table T [n_out, tn] holds one row per output
// channel on a lattice whose spacing is the query spacing.  For every kv
// row r = bg * kv + k of R rows, with integer tap ox and fraction f, and
// every channel c and query n < n_q,
//     out[bg, c, k, n] = T[c, ox+n] * (1-f) + T[c, ox+n+1] * f
// rounded in that order: 1-f, the two products, then their sum, each
// rounded separately (__fsub_rn / __fmul_rn / __fadd_rn), as the plain
// PyTorch version (ops/cpb1d.py table1d_interp_reference) rounds them, so
// the two agree bitwise.  Taps and fractions come from ops/cpb1d.py
// table1d_taps (the port of _tbl1_idx); a clipped row has f outside [0, 1]
// and extrapolates, as on the TPU.  The output goes straight into the
// kv-major attention layout [B*G, n_out, K, n_q] (= [B, H, K, N], head
// g * n_out + c): the TPU builds [R, n_out, n_q] and transposes it, a
// second pass over the whole bias that this kernel does not make.
//
// What bounds it on the card: the output write.  At the deformpathomic
// preset (B=4, G=4, K=625, n_out=2, n_q=2501) a call writes 200 MB and
// reads a 40 KB table (counted from the shapes), ~3 flops per 4 output
// bytes.
//
// What the design does about that: one block per (row, channel) writes
// that row's contiguous n_q outputs, thread i at i, i+256, ..., so a warp
// stores 128 contiguous bytes; the two table reads per output are
// neighbours of the stores' pattern and stay in L1/L2 (the table is 40 KB).
// The TPU kernel's lane rolls and single-sublane rows are not needed: the
// window is addressed directly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cpb_table_1d_fwd_kernel(const float* __restrict__ table, int n_out, int tn,
                        const int* __restrict__ taps,
                        const float* __restrict__ fracs,
                        float* __restrict__ out, int kv, int n_q) {
  const int r = blockIdx.x;
  const int c = blockIdx.y;
  const int bg = r / kv;
  const int k = r - bg * kv;
  // the taps are clipped on the host side so that the window and its +1
  // neighbour lie inside the table; clamping again keeps a bad tap in bounds
  const int ox = min(max(taps[r], 0), tn - n_q - 1);
  const float f = fracs[r];
  const float g = __fsub_rn(1.0f, f);
  const float* t = table + static_cast<size_t>(c) * tn + ox;
  float* o = out + ((static_cast<size_t>(bg) * n_out + c) * kv + k) * n_q;
  for (int n = threadIdx.x; n < n_q; n += blockDim.x) {
    o[n] = __fadd_rn(__fmul_rn(__ldg(t + n), g), __fmul_rn(__ldg(t + n + 1), f));
  }
}

}  // namespace

// table [n_out, tn] f32, taps [rows] int32, fracs [rows] f32, rows a
// multiple of kv -> out [rows / kv, n_out, kv, n_q] f32.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dmlt_cpb_table_1d_fwd(const void* table, int n_out, int tn,
                                     const void* taps, const void* fracs,
                                     void* out, int rows, int kv, int n_q,
                                     void* stream) {
  if (rows == 0 || n_out == 0) return 0;
  cpb_table_1d_fwd_kernel<<<dim3(rows, n_out), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_out, tn,
      static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<float*>(out), kv, n_q);
  return static_cast<int>(cudaGetLastError());
}
