// An alternative design of K5-fwd (csrc/cpb_table_strided.cu), kept for
// tools/torch_k2_compare.py --kernel k5, which builds it as a variant of
// the kernel: a band of phase-plane rows staged in shared memory for the
// rows of one phase.  It measured slower than the kernel's own design
// (PERF.md): staging a band and ordering the rows cost about as much as
// that design's whole call, and the writes that follow do not overlap it.
//
// The rows are put in classes: a phase (y0 % d, x0 % d) and a band of hb
// window origins oy = y0 / d.  Block b of a one-wave grid takes the rows at
// positions [R b / G, R (b + 1) / G) of the rows ordered by (class, index)
// (every block counts the classes of all rows in shared memory); for each
// class those positions meet, it stages the class's plane rows as pairs
// (T[d Y + py + ay, d X + px], T[d Y + py + ay, d X + px + 1]) for ay = 0,
// 1 and every X (about 204 KB at side 50, d 2 or 4), lists its rows of the
// class by ballots in index order, and writes their windows from shared
// memory, each product and sum rounded as the plain version.  The text is
// included into cpb_table_strided.cu's anonymous namespace after its
// store() overloads.

constexpr int kBandThreads = 512;
constexpr int kListMax = 256;    // rows a block takes, at most
constexpr int kClassMax = 256;   // classes d^2 * bands (a class id is a byte)
// the dynamic shared memory of a block: an H100 block's 227 KB, less
// room for the kernel's static shared memory
constexpr int kSmemMax = 226 * 1024;

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

// The band plan: a class is a phase (y0 % d, x0 % d) and a band of hb
// window origins oy = y0 / d; its block stages plane rows Y of oy's band
// and the side - 1 after, each as pairs (T[d Y + py + ay, d X + px],
// T[d Y + py + ay, d X + px + 1]) for ay = 0, 1 and every X.
struct BandPlan {
  int nx;    // pair columns X of a plane row
  int hb;    // window origins of a band
  int nb;    // bands
  int ny;    // plane rows staged: hb + side - 1
  int smem;  // bytes of shared memory; 0: no band fits
};

inline BandPlan band_plan(int tn_rows, int tn_cols, int rows, int side, int d,
                          int grid) {
  BandPlan p{};
  const int reach = d * (side - 1) + 2;
  if (tn_rows < reach || tn_cols < reach) return p;
  p.nx = (tn_cols - 2) / d + 1;
  const int noy = (tn_rows - reach) / d + 1;
  const long long fixed =
      align16(rows) + 8LL * kClassMax + 16LL * kListMax;
  const long long per_y = 16LL * p.nx;
  const long long h = (kSmemMax - fixed) / per_y - side + 1;
  if (h < 1 || (rows + grid - 1) / grid > kListMax) return BandPlan{};
  p.nb = static_cast<int>((noy + h - 1) / h);
  if (d * d * p.nb > kClassMax) return BandPlan{};
  p.hb = (noy + p.nb - 1) / p.nb;
  p.ny = p.hb + side - 1;
  p.smem = static_cast<int>(per_y * p.ny + fixed);
  return p;
}

struct BandRow {
  int r;    // the row
  int win;  // its window's first pair in the staged band
  float fy, fx;
};

// Block b takes the rows at positions [R b / G, R (b + 1) / G) of the
// rows ordered by (class, index); for each class those positions meet, it
// stages the class's band, lists its rows there, and writes their
// windows, every thread a fixed step of the block's outputs on.
template <typename Out>
__global__ void __launch_bounds__(kBandThreads, 1)
strided_band_kernel(const float* __restrict__ table, int tn_rows,
                    int tn_cols, const int* __restrict__ taps,
                    const float* __restrict__ fracs, Out* __restrict__ out,
                    int rows, int side, int d, BandPlan p) {
  extern __shared__ __align__(16) float2 s_stage[];
  int* s_hist = reinterpret_cast<int*>(s_stage + 2 * p.nx * p.ny);
  int* s_pref = s_hist + kClassMax;
  BandRow* s_list = reinterpret_cast<BandRow*>(s_pref + kClassMax);
  unsigned char* s_cls = reinterpret_cast<unsigned char*>(s_list + kListMax);
  __shared__ int s_warp[kBandThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int classes = d * d * p.nb;
  const int reach = d * (side - 1) + 2;
  // every row's class, and the rows of each class
  for (int c = t; c < classes; c += kBandThreads) s_hist[c] = 0;
  __syncthreads();
  for (int r = t; r < rows; r += kBandThreads) {
    const int y0 = min(max(__ldg(taps + 2 * r), 0), tn_rows - reach);
    const int x0 = min(max(__ldg(taps + 2 * r + 1), 0), tn_cols - reach);
    const int c = ((y0 % d) * d + x0 % d) * p.nb + min(y0 / d / p.hb,
                                                       p.nb - 1);
    s_cls[r] = static_cast<unsigned char>(c);
    atomicAdd(s_hist + c, 1);
  }
  __syncthreads();
  for (int c = t; c < classes; c += kBandThreads) {
    int before = 0;
    for (int k = 0; k < c; ++k) before += s_hist[k];
    s_pref[c] = before;
  }
  __syncthreads();
  const int p0 = static_cast<int>(static_cast<long long>(rows) * blockIdx.x /
                                  gridDim.x);
  const int p1 = static_cast<int>(static_cast<long long>(rows) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int n = side * side;
  const int step_i = kBandThreads / n;  // rows a step passes
  const int step_y = (kBandThreads - step_i * n) / side;
  const int step_x = kBandThreads - step_i * n - step_y * side;
  for (int c = 0; c < classes; ++c) {
    const int pc = s_pref[c];
    const int nc = s_hist[c];
    if (nc == 0 || pc >= p1 || pc + nc <= p0) continue;
    const int lo = max(p0, pc) - pc;
    const int hi = min(p1, pc + nc) - pc;
    const int phase = c / p.nb;
    const int py = phase / d;
    const int px = phase - py * d;
    const int ylo = (c - phase * p.nb) * p.hb;
    __syncthreads();  // the previous class's windows are written
    // the band: s_stage[(2 (Y - ylo) + ay) nx + X]
    const int n_pairs = 2 * p.nx * p.ny;
#pragma unroll 4
    for (int e = t; e < n_pairs; e += kBandThreads) {
      const int yy = e / p.nx;
      const int X = e - yy * p.nx;
      const int row = d * (ylo + (yy >> 1)) + py + (yy & 1);
      const int col = d * X + px;
      float a = 0.0f;
      float b = 0.0f;
      if (row < tn_rows) {
        const float* q = table + static_cast<size_t>(row) * tn_cols + col;
        if (col < tn_cols) a = __ldg(q);
        if (col + 1 < tn_cols) b = __ldg(q + 1);
      }
      s_stage[e] = make_float2(a, b);
    }
    // the class's rows of ranks [lo, hi), in index order
    int seen = 0;
    for (int base = 0; base < rows && seen < hi; base += kBandThreads) {
      const int r = base + t;
      const bool in = r < rows && s_cls[r] == c;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (lane == 0) s_warp[warp] = __popc(m);
      __syncthreads();
      int rank = seen + __popc(m & ((1u << lane) - 1u));
      for (int k = 0; k < kBandThreads / 32; ++k) {
        const int v = s_warp[k];
        rank += k < warp ? v : 0;
        seen += v;
      }
      if (in && rank >= lo && rank < hi) {
        const int y0 = min(max(__ldg(taps + 2 * r), 0), tn_rows - reach);
        const int x0 = min(max(__ldg(taps + 2 * r + 1), 0), tn_cols - reach);
        s_list[rank - lo] = {r, 2 * (y0 / d - ylo) * p.nx + x0 / d,
                             __ldg(fracs + 2 * r), __ldg(fracs + 2 * r + 1)};
      }
      __syncthreads();  // s_warp is read before the next tile writes it
    }
    // the rows' windows: thread t takes the block's outputs t, t +
    // kBandThreads, ... (row i, window (y, x)), each a fixed step on
    const int total = (hi - lo) * n;
    int i = t / n;
    int y = (t - i * n) / side;
    int x = t - i * n - y * side;
    int cur = -1;
    BandRow q{};
    float gy = 0.0f;
    float gx = 0.0f;
    for (int j = t; j < total; j += kBandThreads) {
      if (i != cur) {
        cur = i;
        q = s_list[i];
        gy = __fsub_rn(1.0f, q.fy);
        gx = __fsub_rn(1.0f, q.fx);
      }
      const float2* w = s_stage + q.win + 2 * y * p.nx + x;
      const float2 u = w[0];
      const float2 v = w[p.nx];
      const float a = __fadd_rn(__fmul_rn(u.x, gy), __fmul_rn(v.x, q.fy));
      const float b = __fadd_rn(__fmul_rn(u.y, gy), __fmul_rn(v.y, q.fy));
      store(out + static_cast<size_t>(q.r) * n + y * side + x,
            __fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, q.fx)));
      x += step_x;
      y += step_y;
      if (x >= side) {
        x -= side;
        ++y;
      }
      i += step_i;
      if (y >= side) {
        y -= side;
        ++i;
      }
    }
  }
}

// the SMs of the current device, asked once
inline int sm_count() {
  static const int sms = [] {
    int dev = 0;
    int n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    return n;
  }();
  return sms;
}

template <typename Out>
int launch_band(const float* table, int tn_rows, int tn_cols, const int* taps,
                const float* fracs, Out* out, int rows, int side, int d,
                const BandPlan& p, int grid, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      strided_band_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  strided_band_kernel<Out><<<grid, kBandThreads, p.smem, s>>>(
      table, tn_rows, tn_cols, taps, fracs, out, rows, side, d, p);
  return static_cast<int>(cudaGetLastError());
}

// the band design's launch where a band fits, else -1 (the caller launches
// the committed design)
template <typename Out>
int band_launch(const float* table, int tn_rows, int tn_cols, const int* taps,
                const float* fracs, Out* out, int rows, int side, int d,
                cudaStream_t s) {
  const int grid = sm_count();
  if (grid == 0) return -1;
  const BandPlan p = band_plan(tn_rows, tn_cols, rows, side, d, grid);
  if (p.smem == 0) return -1;
  return launch_band(table, tn_rows, tn_cols, taps, fracs, out, rows, side, d,
                     p, grid, s);
}
