// K6-bwd: gradient of the fused divisor-1 table attention (fused_table.cu).
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _v10_bwd_kernel (the TPU kernel behind the custom VJP of
// fused_table_attention, _v10_vjp_bwd, with_gattn=True).
//
// The attention's gradient up to the bias cotangent ds [BH, K, N] is the
// kernel of fused_attention_bwd.cuh ("kn" layout; its note gives what it
// computes, what bounds it and why it is deterministic).  ds is the
// cotangent of the bias windows, laid out as [BH*K, side, side]; the
// wrapper (ops/fused_table.py) hands it to K1-bwd's kernels
// (cpb_table_bwd.cu), which scatter it into the table cotangent and sum
// each row's shift cotangent, deterministically.  The TPU kernel does that
// scatter in the same kernel; fusing it here is later work.

#include <cuda_runtime.h>

#include "fused_attention_bwd.cuh"

// Shared memory of one K6-bwd block, in bytes.
extern "C" int dmlt_fused_table_bwd_smem(int K, int D) {
  return fused_attention_bwd_smem(K, D);
}

// q [BH, N, D] (pre-scaled), k, v [BH, K, D], attn [BH, K, N] (before
// dropout), gout [BH, N, D], gattn [BH, K, N] or null (no map cotangent),
// all f32 -> dq [BH, N, D], dkv [2, BH, K, D] (dk, then dv) and ds
// [BH, K, N], f32.  partial is scratch of splits * 2 * BH * K * D f32;
// split s of a bh takes the 64-query tiles s, s + splits, ...  threshold
// and scale as in dmlt_fused_table_fwd, seed the forward's (one int64 on
// the card).  Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int dmlt_fused_table_bwd(const void* q, const void* k,
                                    const void* v, const void* attn,
                                    const void* gout, const void* gattn,
                                    void* dq, void* dkv, void* ds,
                                    void* partial, int BH, int K, int N,
                                    int D, int splits, const void* seed,
                                    int threshold, float scale,
                                    void* stream) {
  return fused_attention_bwd(q, k, v, attn, gout, gattn, dq, dkv, ds, partial,
                             BH, K, N, D, splits, 0, seed, 0, threshold, scale,
                             static_cast<cudaStream_t>(stream));
}
