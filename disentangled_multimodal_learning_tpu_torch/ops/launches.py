"""The kernels' launch counters, by name.

Each wrapper of ``ops/`` adds one to its ``launches`` where it launches its
kernel, and nowhere else.  A CUDA graph (``train/graph_chunk.py``) runs
its kernels with no Python: its capture records them, and runs none, so the
capture's counts are taken back out of ``launches``, and each replay adds
them to ``launches`` again.

The plain-torch cores of :data:`CORES` are counted by call instead (each
call launches many of torch's kernels): a core adds one to its ``calls``
a call, and a graph takes back and adds again its capture's calls alike.
"""

from __future__ import annotations

from . import cpb, cpb1d, dpc_knn, fused_exact, fused_table, nystrom

WRAPPERS = {"k1_fwd": cpb.table_interp,
            "k1_bwd": cpb.table_interp_backward,
            "k2_fwd": cpb.cpb_bias_transposed,
            "k2_bwd": cpb.cpb_bias_transposed_backward,
            "k3_knn": dpc_knn.knn_stream,
            "k3_parent": dpc_knn.parent_stream,
            "k4_fwd": cpb1d.table1d_interp,
            "k4_bwd": cpb1d.table1d_interp_backward,
            "k5_fwd": cpb.table_interp_strided,
            "k5_bwd": cpb.table_interp_strided_backward,
            "k6_fwd": fused_table.fused_table_attention,
            "k6_bwd": fused_table.fused_table_attention_backward,
            "k2nk_fwd": cpb.cpb_bias_nk,
            "k2nk_bwd": cpb.cpb_bias_nk_backward,
            "k7_fwd": fused_exact.fused_exact_attention,
            "k7_bwd": fused_exact.fused_exact_attention_backward}


CORES = {"nystrom": nystrom.nystrom_attention}


def counts() -> dict:
    """Every kernel's launches, eager and replayed."""
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def reset() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in CORES.values():
        fn.calls = 0


def core_calls() -> dict:
    """Every core's calls, eager and replayed."""
    return {k: fn.calls for k, fn in CORES.items()}
