"""The reduction of a profiled stretch: busy time as a union, idle gaps
named by the host operation under them, kernels matched by whole
names."""

from bench_port import trace as tr


def _trace():
    device = [("k1", 0, 100), ("k2", 50, 150), ("Memcpy HtoD (Pageable -> "
              "Device)", 300, 400), ("void table1d_bwd_tile_kernel<1>", 500,
                                     520),
              ("void table_bwd_tile_kernel<true>(float)", 600, 700)]
    host = [("aten::copy_", 140, 320), ("cudaMemcpyAsync", 160, 310),
            ("aten::add", 450, 650)]
    return tr.Trace(device, host, 1e-6)


def test_busy_is_a_union():
    t = _trace()
    assert tr.busy_intervals(t.device)[0] == [0, 150]
    assert tr.busy_s(t) == (150 + 100 + 20 + 100) / 1e9


def test_idle_gaps_name_the_innermost_host_op():
    gaps = tr.idle_gaps(_trace())
    assert [g[0] for g in gaps] == ["aten::copy_", "host outside any operator",
                                    "aten::add"]
    assert [g[1] for g in gaps] == [150 / 1e9, 100 / 1e9, 80 / 1e9]


def test_kernels_match_by_whole_name():
    hit = tr.matching(_trace(), ["table_bwd_tile_kernel"])
    assert [e[0] for e in hit] == ["void table_bwd_tile_kernel<true>(float)"]
    assert tr.total_s(hit) == 100 / 1e9
    assert [e for e in _trace().device if tr.is_h2d(e[0])][0][1] == 300
    assert tr.top_ops(_trace(), 1) == [["k1", 100 / 1e9]]
