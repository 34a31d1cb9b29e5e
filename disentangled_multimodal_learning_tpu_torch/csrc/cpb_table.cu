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
// values (46 MB; 23 MB with the bf16 store), at ~2 flops per output byte.
//
// What the design does about that: a persistent grid of one wave (two
// blocks of 256 threads an SM at the preset).  Each block first copies the
// whole table into shared memory with cp.async (77 KB at the preset; a
// table over a block's 227 KB is read from global memory through L1
// instead), then walks its rows (blockIdx.x, + gridDim.x, ...), the taps
// and fractions of 64 of them read into shared memory at once, with no
// barrier between rows.  Staging each row's (side+1)^2 window instead (the
// TPU kernel's way, and this kernel's first plan) reads as many bytes from
// L2 as the row writes; the whole table is read once per block.  The
// threads write a row's side^2 outputs as 4-output vectors (16 B in f32,
// 8 B with the bf16 store: two packed bf16 pairs), a warp 512 or 256
// contiguous bytes a store; a row start that is not vector-aligned (odd
// sides) takes a scalar head and tail.  Each thread finds its vectors'
// (y, x) by one division a row and then steps by a fixed (row, column)
// increment, so no output costs a division; a vector's four outputs take
// the y-blends at their own entries and right of the two outputs whose
// right neighbour is not the next output (at most one step to the next
// window row), six y-blends for four outputs with the same ops in every
// lane.  Every product and sum is rounded separately (__fmul_rn /
// __fadd_rn), so the result is bitwise that of the plain PyTorch version
// (ops/cpb.py table_interp_reference), which rounds each op the same way.
// Under cpb_table_bf16 (the TPU's TBL_BF16_OUT) the blend stays f32 and
// only the store rounds to bf16 (round to nearest even, as the plain
// version's .to(torch.bfloat16)), halving the write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // outputs a vector store writes
constexpr int kRowChunk = 64;  // rows whose taps a block reads at once
// the largest table a block keeps in shared memory (the H100's 227 KB a
// block); a larger one is read from global memory through L1
constexpr int kSharedTableMax = 227 * 1024;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// kVec outputs at p (aligned to kVec outputs): a float4 in f32, two packed
// bf16 pairs with the bf16 store
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[kVec]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// 4 or 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// a table value: from shared memory, or from global memory through L1
template <bool kShared>
__device__ __forceinline__ float tv(const float* p) {
  return kShared ? *p : __ldg(p);
}

struct Row {
  int y0, x0;
  float fy, fx;
};

// The row's taps, clamped as the host clips them so that the window lies
// inside the table (a bad tap cannot read out of bounds), and fractions.
__device__ __forceinline__ Row load_row(const int* taps, const float* fracs,
                                        int r, int tn_rows, int tn_cols,
                                        int w) {
  return {min(max(__ldg(taps + 2 * r), 0), tn_rows - w),
          min(max(__ldg(taps + 2 * r + 1), 0), tn_cols - w),
          __ldg(fracs + 2 * r), __ldg(fracs + 2 * r + 1)};
}

// out(y, x) of the window at t (table rows `stride` apart), rounded op by
// op as the plain version
template <bool kShared>
__device__ __forceinline__ float blend(const float* t, int stride, float fy,
                                       float gy, float fx, float gx) {
  const float a = __fadd_rn(__fmul_rn(tv<kShared>(t), gy),
                            __fmul_rn(tv<kShared>(t + stride), fy));
  const float b = __fadd_rn(__fmul_rn(tv<kShared>(t + 1), gy),
                            __fmul_rn(tv<kShared>(t + stride + 1), fy));
  return __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, fx));
}

// One row's side^2 outputs o[] from its window at win (its first table
// entry; table rows `stride` apart): a scalar head up to the first
// vector-aligned output, vectors of kVec, a scalar tail.  Thread t takes
// the vectors t, t + kThreads, ...: the first at (y_t, x_t) = (kVec t) /
// side, side (the caller's one division) moved on by the head, the next
// each a fixed step of kThreads * kVec outputs on.
template <bool kShared, typename Out>
__device__ __forceinline__ void write_row(Out* __restrict__ o,
                                          const float* win, int stride,
                                          int side, const Row& q, int y_t,
                                          int x_t, int step_y, int step_x) {
  const int n = side * side;
  const float gy = __fsub_rn(1.0f, q.fy);
  const float gx = __fsub_rn(1.0f, q.fx);
  constexpr unsigned kAlign = kVec * sizeof(Out);
  const int head = min(
      n, static_cast<int>(((kAlign - reinterpret_cast<uintptr_t>(o) % kAlign) %
                           kAlign) / sizeof(Out)));
  const int body = (n - head) / kVec;
  const int tail = head + kVec * body;
  // the head and tail, fewer than 2 kVec outputs
  const int t = threadIdx.x;
  if (t < head + n - tail) {
    const int i = t < head ? t : tail + t - head;
    const int y = i / side;
    store(o + i, blend<kShared>(win + y * stride + i - y * side, stride,
                                q.fy, gy, q.fx, gx));
  }
  if (t >= body) return;
  int y = y_t;
  int x = x_t + head;
  while (x >= side) {
    x -= side;
    ++y;
  }
  for (int j = t; j < body; j += kThreads) {
    float v[kVec];
    const float* a = win + y * stride + x;
    if (side >= kVec) {
      // the kVec outputs, at most one step to the next window row (after
      // output m, the one in the last column; m = kVec - 1 if none): the
      // y-blends at the outputs and right of outputs m and kVec - 1, the
      // same ops in every lane
      const int m = min(kVec - 1, side - 1 - x);
      float ty[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float* ak = a + k + (k > m ? stride - side : 0);
        ty[k] = __fadd_rn(__fmul_rn(tv<kShared>(ak), gy),
                          __fmul_rn(tv<kShared>(ak + stride), q.fy));
      }
      const float* am = a + m + 1;
      const float* a3 = a + kVec + (m < kVec - 1 ? stride - side : 0);
      const float edge_m = __fadd_rn(__fmul_rn(tv<kShared>(am), gy),
                                     __fmul_rn(tv<kShared>(am + stride), q.fy));
      const float edge_3 = __fadd_rn(__fmul_rn(tv<kShared>(a3), gy),
                                     __fmul_rn(tv<kShared>(a3 + stride), q.fy));
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float right = k == m ? edge_m
                            : k == kVec - 1 ? edge_3 : ty[k + 1];
        v[k] = __fadd_rn(__fmul_rn(ty[k], gx), __fmul_rn(right, q.fx));
      }
    } else {
      int xk = x;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[k] = blend<kShared>(a, stride, q.fy, gy, q.fx, gx);
        if (++xk == side) {  // on to the next window row
          xk = 0;
          a += stride - side;
        }
        ++a;
      }
    }
    store_vec(o + head + kVec * j, v);
    x += step_x;
    y += step_y;
    if (x >= side) {
      x -= side;
      ++y;
    }
  }
}

// grid: one wave of blocks, block b taking rows b, b + gridDim.x, ...  With
// kShared, the block first copies the whole table into shared memory
// (cp.async, 16 B at a time where the table is 16 B-aligned); every row's
// window is then read there.  The block's rows go in chunks of kRowChunk:
// their taps and fractions are read into shared memory at once (the first
// chunk's while the table lands), so no row waits on a global read; no
// barrier between the rows of a chunk: the table does not change.
template <bool kShared, typename Out>
__global__ void __launch_bounds__(kThreads)
cpb_table_interp_fwd_kernel(const float* __restrict__ table, int tn_rows,
                            int tn_cols, const int* __restrict__ taps,
                            const float* __restrict__ fracs,
                            Out* __restrict__ out, int rows, int side) {
  extern __shared__ __align__(16) float s_table[];
  __shared__ Row s_rows[kRowChunk];
  const int grid = gridDim.x;
  if (static_cast<int>(blockIdx.x) >= rows) return;
  const int w = side + 1;
  const int n = side * side;
  const int step_y = kThreads * kVec / side;
  const int step_x = kThreads * kVec - step_y * side;
  const int y_t = kVec * static_cast<int>(threadIdx.x) / side;
  const int x_t = kVec * static_cast<int>(threadIdx.x) - y_t * side;
  const float* T = table;
  if (kShared) {
    const int size = tn_rows * tn_cols;
    int done = 0;
    if (reinterpret_cast<uintptr_t>(table) % 16 == 0) {
      done = size / 4 * 4;
      for (int i = 4 * threadIdx.x; i < done; i += 4 * kThreads) {
        cp_async16(s_table + i, table + i);
      }
    }
    for (int i = done + threadIdx.x; i < size; i += kThreads) {
      cp_async4(s_table + i, table + i);
    }
    T = s_table;
  }
  for (int c0 = blockIdx.x; c0 < rows; c0 += kRowChunk * grid) {
    __syncthreads();  // the previous chunk's rows have been read
    const int rc = c0 + static_cast<int>(threadIdx.x) * grid;
    if (threadIdx.x < kRowChunk && rc < rows) {
      s_rows[threadIdx.x] = load_row(taps, fracs, rc, tn_rows, tn_cols, w);
    }
    if (kShared && c0 == static_cast<int>(blockIdx.x)) cp_async_wait_all();
    __syncthreads();
    for (int i = 0, r = c0; i < kRowChunk && r < rows; ++i, r += grid) {
      const Row q = s_rows[i];
      write_row<kShared>(out + static_cast<size_t>(r) * n,
                         T + static_cast<size_t>(q.y0) * tn_cols + q.x0,
                         tn_cols, side, q, y_t, x_t, step_y, step_x);
    }
  }
}

// Whether a block keeps the table in shared memory, and its bytes there.
inline bool shared_table(int tn_rows, int tn_cols) {
  return static_cast<long long>(tn_rows) * tn_cols * 4 <= kSharedTableMax;
}

// The blocks of one SM for this table (its shared memory, if it is kept
// there), after opting the kernel in to them; 0 if the runtime refuses.
template <bool kShared, typename Out>
int blocks_per_sm(int smem) {
  auto* kernel = cpb_table_interp_fwd_kernel<kShared, Out>;
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return per_sm;
}

template <typename Out>
int blocks_per_sm(int tn_rows, int tn_cols) {
  return shared_table(tn_rows, tn_cols)
             ? blocks_per_sm<true, Out>(tn_rows * tn_cols * 4)
             : blocks_per_sm<false, Out>(0);
}

template <bool kShared, typename Out>
int launch(const float* table, int tn_rows, int tn_cols, const int* taps,
           const float* fracs, Out* out, int rows, int side,
           cudaStream_t s) {
  const int smem = kShared ? tn_rows * tn_cols * 4 : 0;
  const int per_sm = blocks_per_sm<kShared, Out>(smem);
  if (per_sm == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidConfiguration);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave: every block resident at once
  const int blocks = min(rows, per_sm * sms);
  cpb_table_interp_fwd_kernel<kShared, Out><<<blocks, kThreads, smem, s>>>(
      table, tn_rows, tn_cols, taps, fracs, out, rows, side);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int launch(const float* table, int tn_rows, int tn_cols, const int* taps,
           const float* fracs, Out* out, int rows, int side,
           cudaStream_t s) {
  return shared_table(tn_rows, tn_cols)
             ? launch<true>(table, tn_rows, tn_cols, taps, fracs, out, rows,
                            side, s)
             : launch<false>(table, tn_rows, tn_cols, taps, fracs, out, rows,
                             side, s);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* tp = static_cast<const int*>(taps);
  const float* f = static_cast<const float*>(fracs);
  if (out_bf16) {
    return launch(t, tn_rows, tn_cols, tp, f,
                  static_cast<__nv_bfloat16*>(out), rows, side, s);
  }
  return launch(t, tn_rows, tn_cols, tp, f, static_cast<float*>(out), rows,
                side, s);
}

// The blocks an SM holds (what one wave puts on each SM) for this table
// and store; 0 if the runtime refuses the launch's shared memory.
extern "C" int dmlt_cpb_table_interp_fwd_blocks(int out_bf16, int tn_rows,
                                                int tn_cols) {
  return out_bf16 ? blocks_per_sm<__nv_bfloat16>(tn_rows, tn_cols)
                  : blocks_per_sm<float>(tn_rows, tn_cols);
}

extern "C" const char* dmlt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
