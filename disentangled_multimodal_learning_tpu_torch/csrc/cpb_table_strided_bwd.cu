// K5-bwd: gradient of the table-interpolated CPB bias windows at lattice
// divisor d >= 2.
//
// Replaces disentangled_multimodal_learning_tpu/ops/pallas/deform_attn.py
// _tbl_bwd_kernel (the TPU kernel behind the custom VJP of _table_interp
// at divisor >= 2, _tbl_vjp_bwd).  The TPU kernel takes d/dfx as the
// difference of two y-blends; here it is a blend of exact differences of
// neighbouring table entries (the same value, with less rounding).
//
// What it computes, what bounds it and the design: table_bwd_tiles.cuh,
// shared with K1-bwd (divisor 1).  At d >= 2 an entry of the table takes
// one dw value of a row, through the tap (Y, X) in {0, 1}^2 that reaches
// its phase; a block holds all d^2 phases of its tile (at most 16, else
// the phases split over nz blocks), so the four warps a row reaches read
// the same dw lines.  At production shapes (R = 4608, side = 50) that is
// 46 MB of dw (23 MB in bf16), and the table cotangent is 274^2 (d = 2)
// or 544^2 (d = 4) f32, counted from the shapes.

#include "table_bwd_tiles.cuh"

// As dmlt_cpb_table_interp_bwd (cpb_table_bwd.cu) at lattice divisor
// d >= 2, with strip 8.
extern "C" int dmlt_cpb_table_strided_bwd(const void* table, int tn_rows,
                                          int tn_cols, const void* taps,
                                          const void* fracs, const void* dout,
                                          int dout_bf16, void* dtable,
                                          void* dfracs, void* partial,
                                          void* dpart, int rows, int side,
                                          int d, int strip, int wpp,
                                          int phases, int groups,
                                          void* stream) {
  return table_bwd_tiles<8, false>(table, tn_rows, tn_cols, taps, fracs,
                                   dout, dout_bf16, dtable, dfracs, partial,
                                   dpart, rows, side, d, strip, wpp, phases,
                                   groups, stream);
}
