// K7-bwd: gradient of the fused exact-CPB attention (fused_exact.cu), with
// the map and its cotangent in the "nk" or the "kn" layout.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _bwd_kernel (the custom VJP of fused_deform_attention, "nk") and
// _kn_bwd_kernel (v8, the custom VJP of fused_deform_attention_kn, "kn").
// Both add the map's own cotangent to dp before the softmax backward
// (:173, :1748), as this does.
//
// The attention's gradient up to the bias cotangent ds [BH, K, N] (dq, and
// dk and dv as per-block partials summed in block order) is the kernel of
// fused_attention_bwd.cuh, with its layout flag on the loads of the map
// and its cotangent; its note gives what it computes, what bounds it and
// why it is deterministic.  ds is the cotangent of the CPB bias; the
// wrapper (ops/fused_exact.py) hands it to K2-bwd's kernels
// (cpb_exact_bwd.cu), which recompute the MLP at every point and give the
// grid_kv and weight cotangents as block partials summed in a fixed order.
// The TPU kernels run that MLP backward inside the attention kernel;
// fusing it here (and keeping ds, 46 MB at the teacher's shapes, out of
// device memory) is later work.

#include <cuda_runtime.h>

#include "fused_attention_bwd.cuh"

// Shared memory of one K7-bwd block, in bytes.
extern "C" int dmlt_fused_exact_bwd_smem(int K, int D) {
  return fused_attention_bwd_smem(K, D);
}

// q [BH, N, D] (pre-scaled), k, v [BH, K, D], attn (before dropout) and
// gattn (or null: no map cotangent) [BH, N, K] (nk = 1) or [BH, K, N] (nk
// = 0), gout [BH, N, D], all f32 -> dq [BH, N, D], dkv [2, BH, K, D] (dk,
// then dv) and ds [BH, K, N], f32.  partial is scratch of splits * 2 * BH
// * K * D f32.  threshold and scale as in dmlt_fused_exact_fwd.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int dmlt_fused_exact_bwd(const void* q, const void* k,
                                    const void* v, const void* attn,
                                    const void* gout, const void* gattn,
                                    void* dq, void* dkv, void* ds,
                                    void* partial, int BH, int K, int N,
                                    int D, int splits, int nk, int seed,
                                    int threshold, float scale,
                                    void* stream) {
  return fused_attention_bwd(q, k, v, attn, gout, gattn, dq, dkv, ds, partial,
                             BH, K, N, D, splits, nk, nullptr, seed,
                             threshold, scale,
                             static_cast<cudaStream_t>(stream));
}
