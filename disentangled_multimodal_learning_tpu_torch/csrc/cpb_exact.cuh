// The per-point arithmetic of the exact CPB MLP, shared by K2-fwd and its
// "nk" sibling (cpb_exact.cu), K2-bwd (cpb_exact_bwd.cu) and the fused
// exact-CPB attention K7 (fused_exact.cu).
//
// For a query coordinate q and a kv coordinate g (2 each):
//     f  = sign(q - g) * log1p(|q - g|)
//     h1 = relu(f @ w1 + b1)                 (2 -> HID)
//     h2 = relu(h1 @ w2 + b2)                (HID -> HID)
//     out[o] = h2 @ w3[:, o] + b3[o]         (HID -> O)
// with every product and sum written out as an fmaf or a rounded add, so
// that each kernel that evaluates a point rounds it the same way: K2 in
// the "kn" and the "nk" layout give bitwise-equal biases, and K7 builds
// the same bias in both of its layouts.  Full f32 (no TF32, no tensor
// cores).
//
// The weights live in shared memory in one block (load_mlp below), read by
// every thread of a warp at the same time (broadcasts).
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kHid = 32;
constexpr int kMaxOut = 64;  // MAX_OUT_CHANNELS in ops/cpb.py

// floats of the weights in shared memory at O output channels
__host__ __device__ constexpr int mlp_floats(int O) {
  return kHid * kHid + 2 * kHid + 2 * kHid + kHid * O + O;
}

struct Mlp {
  const float* w2;  // [HID, HID] (in, out)
  const float* w1;  // [2, HID]
  const float* b1;  // [HID]
  const float* b2;  // [HID]
  const float* w3;  // [HID, O]
  const float* b3;  // [O]
};

// Copies the weights into smem (mlp_floats(O) floats); the caller syncs.
__device__ __forceinline__ Mlp load_mlp(float* smem, const float* w1,
                                        const float* b1, const float* w2,
                                        const float* b2, const float* w3,
                                        const float* b3, int O) {
  Mlp m;
  float* s_w2 = smem;
  float* s_w1 = s_w2 + kHid * kHid;
  float* s_b1 = s_w1 + 2 * kHid;
  float* s_b2 = s_b1 + kHid;
  float* s_w3 = s_b2 + kHid;
  float* s_b3 = s_w3 + kHid * O;
  for (int i = threadIdx.x; i < kHid * kHid; i += blockDim.x) s_w2[i] = w2[i];
  for (int i = threadIdx.x; i < 2 * kHid; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < kHid; i += blockDim.x) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
  }
  for (int i = threadIdx.x; i < kHid * O; i += blockDim.x) s_w3[i] = w3[i];
  if (b3 != nullptr) {
    for (int i = threadIdx.x; i < O; i += blockDim.x) s_b3[i] = b3[i];
  }
  m.w2 = s_w2;
  m.w1 = s_w1;
  m.b1 = s_b1;
  m.b2 = s_b2;
  m.w3 = s_w3;
  m.b3 = s_b3;
  return m;
}

__device__ __forceinline__ float signed_log1p(float p) {
  const float s = (p > 0.0f) ? 1.0f : ((p < 0.0f) ? -1.0f : 0.0f);
  return s * log1pf(fabsf(p));
}

// h1 and h2 of the point whose transformed offsets are (fx, fy)
__device__ __forceinline__ void mlp_hidden(const Mlp& m, float fx, float fy,
                                           float (&h1)[kHid],
                                           float (&h2)[kHid]) {
#pragma unroll
  for (int j = 0; j < kHid; ++j) {
    h1[j] = fmaxf(fmaf(fx, m.w1[j], fy * m.w1[kHid + j]) + m.b1[j], 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kHid; ++j) h2[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kHid; ++i) {
#pragma unroll
    for (int j = 0; j < kHid; ++j) h2[j] = fmaf(h1[i], m.w2[i * kHid + j], h2[j]);
  }
#pragma unroll
  for (int j = 0; j < kHid; ++j) h2[j] = fmaxf(h2[j] + m.b2[j], 0.0f);
}

// output channel o of O from h2
__device__ __forceinline__ float mlp_out(const Mlp& m, const float (&h2)[kHid],
                                         int o, int O) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kHid; ++j) acc = fmaf(h2[j], m.w3[j * O + o], acc);
  return acc + m.b3[o];
}

}  // namespace
