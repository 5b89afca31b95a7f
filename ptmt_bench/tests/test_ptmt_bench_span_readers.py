"""The readers of the program's own spans and counters
(``ptmt_bench/spans.py``) on records made by hand, and their None where
the run has no such span or counter."""

from __future__ import annotations

import pytest

from ptmt_bench.registry import Registry
from ptmt_bench.spans import CONTEXT_COUNTERS, CONTEXT_DEVICE
from ptmt_bench.trace import Record

READERS = ("scan_ms.step", "rank_fold_ms.step", "merge_ms.step",
           "launch_idle_ms.step", "merge_live_pct.step")


def _counter(name, stage, value):
    return {"name": name, "labels": {"stage": stage}, "value": value}


def two_steps() -> Record:
    """A 10 s window of two steps.  Host: step 0 over [0, 4], its scan
    [0, 1], fold [1, 2], merge [2, 4]; step 1 over [5, 9] alike, shifted;
    the closed-loop driver's call spans around each.  Device: the profiler's
    activities busy over [0.5, 2.2], [2.4, 3.5] and the same 5 s later,
    idle 0.2 s inside each gather; the program's device
    intervals lag their host spans by 0.5 s.  A warm-up step before the
    window [-4, -1] must not count."""
    spans, device = [], []
    for s in (-5.0, 0.0, 5.0):
        spans += [("ptmt_bench.call", s, s + 4.5), ("mine.step", s, s + 4.0),
                  ("mine.scan", s, s + 1.0), ("mine.fold", s + 1.0, s + 2.0),
                  ("mine.merge", s + 2.0, s + 4.0),
                  ("mine.gather", s + 2.0, s + 2.5),
                  ("mine.flag", s + 3.5, s + 4.0)]
        device += [(n, a + 0.5, min(b + 0.5, s + 3.5))
                   for n, a, b in spans[-6:]]
    context = {
        CONTEXT_DEVICE: device,
        CONTEXT_COUNTERS: [
            _counter("repro_mining_rows_counted_total", "rank", 3 * 400),
            _counter("repro_mining_rows_counted_total", "merge", 3 * 400),
            _counter("repro_mining_live_codes_total", "merge", 3 * 22),
        ]}
    return Record(t0=0.0, t1=10.0, calls=2, work=800.0, spans=spans,
                  device=[("kernel", a + s, b + s) for s in (0.0, 5.0)
                          for a, b in ((0.5, 2.2), (2.4, 3.5))],
                  context=context)


def test_device_time_of_each_phase_per_step():
    r, reg = two_steps(), Registry()
    # per step: scan [0.5, 1.5], fold [1.5, 2.5], merge [2.5, 3.5]
    assert reg.reader("scan_ms.step")(r) == pytest.approx(1000.0)
    assert reg.reader("rank_fold_ms.step")(r) == pytest.approx(1000.0)
    assert reg.reader("merge_ms.step")(r) == pytest.approx(1000.0)


def test_idle_charged_to_the_host_span_open_in_it():
    r = two_steps()
    # gaps and the innermost host span open at their middles: [0, 0.5]
    # mine.scan, [2.2, 2.4] and [7.2, 7.4] mine.gather, [3.5, 5.5] and
    # [8.5, 10] the closed-loop driver's call span; only mine.* ones count
    assert Registry().reader("launch_idle_ms.step")(r) == pytest.approx(
        1e3 * (0.5 + 0.2 + 0.2) / 2)
    labels = dict(r.breakdown()["idle_gaps"])
    assert labels == pytest.approx({"mine.scan": 0.5, "mine.gather": 0.4,
                                    "ptmt_bench.call": 3.5})


def test_live_share_of_the_merged_rows():
    assert Registry().reader("merge_live_pct.step")(two_steps()) \
        == pytest.approx(100.0 * 22 / 400)


def test_readers_find_nothing_without_the_program_spans():
    """An untraced run, or the parent's traced run (no program spans, its
    context only B3's work): every reader returns None, none raises."""
    reg = Registry()
    r = two_steps()
    bare = Record(t0=r.t0, t1=r.t1, calls=r.calls, work=r.work,
                  spans=[s for s in r.spans if s[0] == "ptmt_bench.call"],
                  device=r.device, context={"b3": {"ops": 1, "bytes": 1}})
    untraced = Record(t0=0.0, t1=1.0, calls=3, work=3.0, spans=[],
                      device=[], context={})
    for rec in (bare, untraced):
        for name in READERS:
            assert reg.reader(name)(rec) is None, name


def test_readers_find_nothing_outside_the_window_or_without_a_counter():
    reg = Registry()
    r = two_steps()
    late = Record(t0=20.0, t1=30.0, calls=2, work=800.0, spans=r.spans,
                  device=[("kernel", 21.0, 22.0)], context=r.context)
    for name in ("scan_ms.step", "rank_fold_ms.step", "merge_ms.step"):
        assert reg.reader(name)(late) is None
    no_rows = dict(r.context)
    no_rows[CONTEXT_COUNTERS] = [
        c for c in r.context[CONTEXT_COUNTERS]
        if c["labels"]["stage"] != "merge"
        or c["name"] != "repro_mining_rows_counted_total"]
    r.context = no_rows
    assert reg.reader("merge_live_pct.step")(r) is None
