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
// What the design does about that, and why it is deterministic: blocks run
// in no order, so f32 atomics into dT would make every training step
// non-reproducible, and the rows all land on the same small table, so they
// would also contend.  Instead each block keeps the table and a partial dT
// in shared memory (2 x n_out x tn f32, 80 KB at the preset, so the launch
// opts in above 48 KB) and takes a fixed run of rows one after another,
// with a barrier between rows.  Within one row the targets ox+n are
// distinct, so each thread adds to its own entries with no atomics.  The
// row's dshift is a block sum in a fixed tree order (warp shuffles, then
// the warps in order).  Each block writes its partial table to device
// memory; a second kernel sums the partials in block order.  So two runs on
// the same inputs give bitwise-equal results.  The cotangent is read once,
// coalesced (the d[n-1] read is the neighbour thread's and hits L1).  The
// shift sums cancel (terms O(1), the sum much smaller), so everything
// stays in f32 with no fast-math.

#include <cuda_runtime.h>

#include "fixed_order_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cpb_table_1d_bwd_partial_kernel(const float* __restrict__ table, int n_out,
                                int tn, const int* __restrict__ taps,
                                const float* __restrict__ fracs,
                                const float* __restrict__ dout,
                                float* __restrict__ dshifts,
                                float* __restrict__ partial, int rows, int kv,
                                int n_q, int rows_per_block) {
  extern __shared__ float smem[];
  const int tsize = n_out * tn;
  float* s_tab = smem;              // [n_out, tn] the table
  float* s_dtab = s_tab + tsize;    // [n_out, tn] this block's partial dT
  float* s_red = s_dtab + tsize;    // [kWarps]
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) {
    s_tab[i] = table[i];
    s_dtab[i] = 0.0f;
  }

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const int bg = r / kv;
    const int k = r - bg * kv;
    // same clamp as the forward, so a bad tap cannot write out of bounds
    const int ox = min(max(taps[r], 0), tn - n_q - 1);
    const float f = fracs[r];
    const float g = 1.0f - f;
    __syncthreads();  // the previous row's scatter (and s_red) are done
    float sd = 0.0f;
    for (int c = 0; c < n_out; ++c) {
      const float* d =
          dout + ((static_cast<size_t>(bg) * n_out + c) * kv + k) * n_q;
      const float* t = s_tab + c * tn + ox;
      float* dt = s_dtab + c * tn + ox;
      for (int n = threadIdx.x; n <= n_q; n += blockDim.x) {
        const float d0 = (n < n_q) ? d[n] : 0.0f;
        const float d1 = (n > 0) ? d[n - 1] : 0.0f;
        dt[n] += d0 * g + d1 * f;
        if (n < n_q) sd += d0 * (t[n + 1] - t[n]);
      }
    }
    float s[1] = {sd};
    block_sum<kThreads>(s, s_red);
    if (threadIdx.x == 0) dshifts[r] = s[0];
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * tsize;
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) out[i] = s_dtab[i];
}

}  // namespace

// table [n_out, tn] f32, taps [rows] int32, fracs [rows] f32, dout
// [rows / kv, n_out, kv, n_q] f32 -> dtable [n_out, tn] f32 and dshifts
// [rows] f32.  partial is scratch of nparts * n_out * tn f32; block b takes
// rows [b * ceil(rows / nparts), ...).  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int dmlt_cpb_table_1d_bwd(const void* table, int n_out, int tn,
                                     const void* taps, const void* fracs,
                                     const void* dout, void* dtable,
                                     void* dshifts, void* partial, int rows,
                                     int kv, int n_q, int nparts,
                                     void* stream) {
  if (rows == 0 || nparts <= 0 || n_out == 0) return 0;
  const int tsize = n_out * tn;
  const size_t smem = (2 * static_cast<size_t>(tsize) + kWarps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cpb_table_1d_bwd_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = (rows + nparts - 1) / nparts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cpb_table_1d_bwd_partial_kernel<<<nparts, kThreads, smem, s>>>(
      static_cast<const float*>(table), n_out, tn,
      static_cast<const int*>(taps), static_cast<const float*>(fracs),
      static_cast<const float*>(dout), static_cast<float*>(dshifts),
      static_cast<float*>(partial), rows, kv, n_q, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(partial, nparts, tsize, dtable, s);
}
