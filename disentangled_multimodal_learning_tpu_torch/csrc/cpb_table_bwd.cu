// K1-bwd: gradient of the divisor-1 table-interpolated CPB bias windows.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_d1_bwd_kernel (the TPU kernel behind the custom VJP of _table_interp
// at divisor 1, _tbl_vjp_bwd).  The fused table attention's backward
// (fused_table_bwd.cu, K6-bwd) hands its bias cotangent to the same entry.
//
// What it computes, what bounds it and the design: table_bwd_tiles.cuh,
// shared with K5-bwd (divisor >= 2).  At divisor 1 an entry of the table
// takes four dw values of a row through the x-blend m; the warp reads its
// strip's dw rows and the row above, and the left neighbour of each value
// comes from the next lane.  At production shapes (R = 4608, side = 50,
// tn = 139) a call reads the 46 MB of dw once (23 MB in bf16, counted from
// the shapes), and the table receives about 620 contributions per entry.

#include "table_bwd_tiles.cuh"

// table [tn_rows, tn_cols] f32, taps [rows, 2] int32 (y0, x0), fracs
// [rows, 2] f32 (fy, fx), dout [rows, side, side] f32 (bf16 with
// dout_bf16) -> dtable [tn_rows, tn_cols] f32 and dfracs [rows, 2] f32
// (dfy, dfx), at d = 1.  The launch's plan (strip 4, warps per phase,
// phases 1, row groups) is ops/cpb.py table_bwd_plan's; partial is scratch
// of groups * tn_rows * tn_cols f32 and dpart of rows * tiles * 2 f32.
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int dmlt_cpb_table_interp_bwd(const void* table, int tn_rows,
                                         int tn_cols, const void* taps,
                                         const void* fracs, const void* dout,
                                         int dout_bf16, void* dtable,
                                         void* dfracs, void* partial,
                                         void* dpart, int rows, int side,
                                         int d, int strip, int wpp,
                                         int phases, int groups,
                                         void* stream) {
  return table_bwd_tiles<4, true>(table, tn_rows, tn_cols, taps, fracs, dout,
                                  dout_bf16, dtable, dfracs, partial, dpart,
                                  rows, side, d, strip, wpp, phases, groups,
                                  stream);
}
