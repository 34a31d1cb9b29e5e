// f32-accurate products on the tensor cores, by a 3xTF32 split, for K6-fwd
// (fused_table.cu), K7-fwd (fused_exact.cu) and the resident attention
// backward (fused_attention_bwd.cuh).
//
// A TF32 tensor-core product keeps 10 mantissa bits of each operand, about
// 5e-4 relative per product: too coarse for the f32 tolerances the fused
// attentions are held to.  So each f32 operand is split into two TF32
// values, hi = rna(a) and lo = rna(a - hi) (a - hi is exact in f32), and
// a b is formed as hi_a hi_b + hi_a lo_b + lo_a hi_b, all accumulated in
// f32 by mma.sync m16n8k8: the dropped lo_a lo_b and the rounding of lo
// leave about 2^-21 relative per product, near f32's 2^-24, at three
// tensor-core passes.  The two small terms go first, so that they are
// added to the accumulator before the large one, or into an accumulator
// of their own that is added at the end.
// tests/test_torch_tf32_split.py emulates the split at K6's and K7-fwd's
// shapes.
//
// Fragments of mma.sync.m16n8k8 .tf32 (PTX ISA), for lane = 4 g + t:
//     A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//     B (8 x 8, col):   b0 (t, g), b1 (t + 4, g)
//     C (16 x 8, f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// Also cp.async with zero fill, for the double-buffered query tiles, and a
// barrier for a pair of warps.
//
// Everything here has internal linkage: each source that includes it
// compiles to its own object, and the objects link into one library.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// TF32 bits of x rounded to nearest, ties away from zero, 10 mantissa
// bits: half of the last kept bit added to the magnitude, the 13 low bits
// cleared.  For finite x and for infinities these are the bits of
// cvt.rna.tf32.f32, in two integer instructions where the compiler's
// emulation of that cvt takes about five; a NaN may come out as an
// infinity or a zero, but then lo = x - hi is a NaN, and so is the product.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// an operand fragment of N f32 values, split
template <int N>
struct Split {
  uint32_t hi[N];
  uint32_t lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// big + small += a b in 3xTF32: the two small terms into small, the large
// one into big (two accumulators: two chains of dependent mma.sync where a
// warp has only one output tile)
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(small, a.lo, b.hi);
  mma_tf32(small, a.hi, b.lo);
  mma_tf32(big, a.hi, b.hi);
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_3xtf32(c, c, a, b);
}

// the two warps of a pair meet here (barrier `id`, 1 to 15, 64 threads;
// __syncthreads is barrier 0), their shared-memory writes before it seen
// after it
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// 16 bytes from global to shared memory, asynchronously; zero bytes read
// (the destination zero-filled) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` committed groups are still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

}  // namespace
