"""The roofline rule on cases counted by hand, and the per-layer readers
on a record made by hand."""

from __future__ import annotations

import pytest

from ptmt_bench.registry import Registry
from ptmt_bench.roofline import zone_scan
from ptmt_bench.trace import Record


def test_rule_by_hand():
    # ALU operations only: 4 per lane-step (validity, gap, two tests)
    # and 4 per node test (compare u and v, keep the first hit of each)
    assert zone_scan.OPS_PER_LANE_STEP == 4
    assert zone_scan.OPS_PER_NODE_TEST == 4
    # 2 l_max digits of 4 bits in 32-bit words
    assert zone_scan.code_bytes(6) == 8 and zone_scan.code_bytes(4) == 4
    assert zone_scan.code_bytes(7) == 8
    w = zone_scan.zone_scan_work(n_slots=16, n_seeds=10, lane_steps=50,
                                 node_tests=70, l_max=6)
    assert w == {"ops": 4 * 50 + 4 * 70, "bytes": 16 * 13 + 10 * 8}
    assert zone_scan.INT32_OPS_PER_S == pytest.approx(1.672704e13)
    assert zone_scan.bound_s({"ops": 1.672704e13, "bytes": 0}) \
        == pytest.approx(1.0)
    assert zone_scan.bound_s({"ops": 0, "bytes": 6.7e12}) \
        == pytest.approx(2.0)


def test_rule_on_a_walk_counted_by_hand():
    """Three seeds of one zone (delta 10, l_max 3), counted by hand."""
    import numpy as np

    from ptmt_bench.reference import ptmt_ref

    u = np.array([[1, 2, 7, 0]], np.int32)
    v = np.array([[2, 3, 8, 0]], np.int32)
    t = np.array([[0, 4, 20, 20]], np.int32)
    valid = np.array([[True, True, True, False]])
    _, _, steps, nodes = ptmt_ref.zone_counts(
        u, v, t, valid, np.array([1], np.int32), delta=10, l_max=3)
    # seed 0 (1,2): slot 1 absorbed (2 nodes), slot 2 past the window;
    # seed 1 (2,3): slot 2 past the window; seed 2 ends at once
    assert steps.tolist() == [3, 2, 1] and nodes.tolist() == [2, 0, 0]
    w = zone_scan.zone_scan_work(valid.size, 3, int(steps.sum()),
                                 int(nodes.sum()), 3)
    assert w == {"ops": 4 * 6 + 4 * 2, "bytes": 4 * 13 + 3 * 4}


def test_kernel_names():
    b1 = "void fused_zone_scan_kernel<6, false>(int const*, int*)"
    b3 = "void (anonymous namespace)::zone_scan_kernel<6, false>(int const*)"
    assert zone_scan.is_b3(b3) and not zone_scan.is_b3(b1)
    assert not zone_scan.is_b3("void at::native::reduce_kernel<512>")


def record():
    b3 = "void zone_scan_kernel<6, false>"
    return Record(
        t0=0.0, t1=10.0, calls=4, work=400.0,
        spans=[("ptmt_bench.call", 0.0, 2.5), ("mine.sharded", 1.0, 2.0),
               ("ptmt_bench.call", 2.5, 10.0)],
        device=[(b3, 0.5, 0.6), ("sort", 0.55, 0.9), (b3, 4.0, 4.1),
                ("index_add", 5.0, 5.2)],
        context={"b3": {"ops": zone_scan.INT32_OPS_PER_S * 0.01,
                        "bytes": 0}},
        setup_s=3.5)


def test_record_by_hand():
    r = record()
    assert r.rate() == 40.0
    assert r.busy_s() == pytest.approx(0.4 + 0.1 + 0.2)
    assert r.idle_pct() == pytest.approx(93.0)
    assert r.device_s(zone_scan.is_b3) == pytest.approx(0.2)
    assert r.span_s("mine.sharded") == pytest.approx(1.0)
    assert r.span_s("mine.h2d") is None
    assert r.host_label(1.5) == "mine.sharded"
    assert r.host_label(5.5) == "ptmt_bench.call"
    gaps = r.idle_gaps()
    assert gaps[0] == (0.0, 0.5) and gaps[-1] == pytest.approx((5.2, 10.0))
    b = r.breakdown()
    assert b["device_ops"][0] == ["sort", pytest.approx(0.35)]
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(9.3)


@pytest.mark.parametrize("metric,want", [
    ("setup_s", 3.5),
    ("mine_edges_per_s", 40.0),
    ("idle_pct.step", 93.0),
    ("fold_ms.step", 1e3 * (0.7 - 0.2) / 4),
    # bound per call 0.01 s against 0.2 / 4 s of B3 per call
    ("b3_roofline_pct", 100 * 0.01 / 0.05),
])
def test_readers_by_hand(metric, want):
    got = Registry().reader(metric)(record())
    assert got == (None if want is None else pytest.approx(want))


def test_readers_find_nothing_in_an_empty_trace():
    r = Record(t0=0.0, t1=1.0, calls=3, work=3.0, spans=[], device=[],
               context={})
    for metric in ("b3_roofline_pct", "idle_pct.step", "fold_ms.step"):
        assert Registry().reader(metric)(r) is None
