"""Observability layer — registry exactness, span semantics, exports.

The guarantees the rest of the stack leans on:

* histograms are **exact** below the sample bound (nearest-rank, matching
  numpy's ``inverted_cdf``) and degrade to bucket interpolation above it;
* spans nest, time-contain their children, attribute first-call compile
  vs steady-state exec per compile key, and survive exceptions;
* the Chrome-trace and Prometheus exports are schema-valid and the JSON
  snapshot round-trips through ``json``;
* the disabled mode (``NULL_OBS``) is shared no-op singletons — no state,
  no files unless asked, identical call surface.
"""

import argparse
import json
import threading

import numpy as np
import pytest

import repro.obs as obs_mod
from repro.obs import NULL_OBS, Observability, get_obs
from repro.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    MetricsRegistry,
    merged_percentile,
)
from repro.obs.timing import Stopwatch, latency_summary, percentile_ms
from repro.obs.tracing import Tracer


# -- metrics ----------------------------------------------------------------


def test_histogram_exact_below_sample_bound():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms", sample_bound=64)
    rng = np.random.default_rng(3)
    values = rng.uniform(0.01, 900.0, 50)
    for v in values:
        h.observe(v)
    assert h.exact
    for q in (50, 95, 99):
        want = float(np.percentile(values, q, method="inverted_cdf"))
        assert h.percentile(q) == pytest.approx(want)
    snap = h.snapshot()
    assert snap["count"] == 50 and snap["exact"]
    assert snap["p50"] == pytest.approx(h.percentile(50))


def test_histogram_interpolates_above_sample_bound():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms", sample_bound=8)
    values = [0.3, 0.4, 0.6, 1.5, 3.0, 4.0, 7.0, 8.0, 30.0, 700.0]
    for v in values:
        h.observe(v)
    assert not h.exact
    # interpolated percentiles stay inside the containing bucket
    p50 = h.percentile(50)
    assert 2.5 < p50 <= 5.0
    assert h.percentile(99) <= h.snapshot()["max"] == 700.0
    assert h.count == len(values)
    assert h.sum == pytest.approx(sum(values))


def test_histogram_rejects_bad_input():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(3.0, 1.0))
    h = reg.histogram("lat_ms")
    with pytest.raises(ValueError):
        h.percentile(101)
    with pytest.raises(ValueError):
        reg.counter("c_total").inc(-1)


def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", path="a")
    c2 = reg.counter("x_total", path="a")
    assert c1 is c2
    assert reg.counter("x_total", path="b") is not c1
    with pytest.raises(TypeError):
        reg.gauge("x_total", path="a")
    assert reg.find("x_total", path="a") is c1
    assert reg.find("nope") is None


def test_merged_percentile_exact_and_bucketed():
    reg = MetricsRegistry()
    a = reg.histogram("h", tenant="a")
    b = reg.histogram("h", tenant="b")
    va, vb = [1.0, 5.0, 9.0], [2.0, 4.0]
    for v in va:
        a.observe(v)
    for v in vb:
        b.observe(v)
    pooled = np.array(va + vb)
    assert merged_percentile([a, b], 50) == pytest.approx(
        float(np.percentile(pooled, 50, method="inverted_cdf")))
    assert merged_percentile([], 50) == 0.0
    # non-exact path: same edges required
    reg2 = MetricsRegistry()
    big = reg2.histogram("h2", sample_bound=2)
    for v in (0.2, 0.7, 3.0, 40.0):
        big.observe(v)
    assert not big.exact
    p = merged_percentile([big], 50)
    assert 0.5 < p <= 40.0
    odd = reg2.histogram("h3", buckets=(1.0, 2.0))
    odd.observe(1.5)
    with pytest.raises(ValueError):
        merged_percentile([big, odd], 50)


def test_prometheus_exposition_schema():
    reg = MetricsRegistry()
    reg.counter("repro_mining_launches_total", path="fused").inc(3)
    reg.gauge("repro_mining_fused_slots").set(128)
    h = reg.histogram("repro_serving_query_latency_ms", tenant="t0")
    h.observe(1.2)
    h.observe(700.0)
    text = reg.to_prometheus()
    assert "# TYPE repro_mining_launches_total counter" in text
    assert 'repro_mining_launches_total{path="fused"} 3' in text
    assert "# TYPE repro_mining_fused_slots gauge" in text
    assert ("# TYPE repro_serving_query_latency_ms histogram" in text)
    assert ('repro_serving_query_latency_ms_bucket'
            '{le="+Inf",tenant="t0"} 2') in text
    assert "repro_serving_query_latency_ms_count" in text
    assert "repro_serving_query_latency_ms_sum" in text
    # every non-comment line is "name{labels} value"
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name_part, value = line.rsplit(" ", 1)
        float(value)
        assert name_part.startswith("repro_")


def test_snapshot_is_json_roundtrippable():
    reg = MetricsRegistry()
    reg.counter("a_total").inc()
    reg.histogram("b_ms").observe(2.0)
    snap = reg.snapshot()
    assert set(snap) == {"counters", "gauges", "histograms"}
    assert json.loads(json.dumps(snap)) == snap


# -- tracing ----------------------------------------------------------------


def test_span_nesting_and_containment():
    tr = Tracer()
    with tr.span("outer", layer="engine"):
        with tr.span("inner"):
            pass
    events = tr.events()
    assert [e["name"] for e in events] == ["inner", "outer"]
    inner, outer = events
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["args"]["layer"] == "engine"
    assert all(e["ph"] == "X" for e in events)
    assert tr.span_names() == {"inner", "outer"}


def test_compile_exec_attribution():
    tr = Tracer()
    key = ("fused", "pallas", 90, 5)
    for _ in range(3):
        with tr.span("mine.fused", compile_key=key):
            pass
    phases = [e["args"]["phase"] for e in tr.events()]
    assert phases == ["compile", "exec", "exec"]
    att = tr.attribution()[repr(key)]
    assert att["span"] == "mine.fused"
    assert att["exec_calls"] == 2
    assert att["compile_ms"] >= 0.0
    assert att["exec_ms_min"] is not None


def test_span_error_and_set_and_sync():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert tr.events()[0]["args"]["error"] == "RuntimeError"
    with tr.span("ok") as sp:
        sp.set(zones=7).sync(np.zeros(4))  # block_until_ready accepts numpy
    assert tr.events()[-1]["args"]["zones"] == 7


def test_tracer_bounded_buffer():
    tr = Tracer(max_events=2)
    for i in range(4):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 2
    assert tr.dropped == 2
    assert tr.to_chrome_trace()["otherData"]["dropped_events"] == 2


def test_chrome_trace_schema(tmp_path):
    tr = Tracer()
    with tr.span("a", compile_key=("k",)):
        pass
    path = tmp_path / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert events[0]["ph"] == "M"  # process_name metadata first
    for e in events[1:]:
        assert e["ph"] == "X"
        assert isinstance(e["ts"], (int, float))
        assert isinstance(e["dur"], (int, float))
        assert e["pid"] and e["tid"]
    assert repr(("k",)) in doc["otherData"]["attribution"]


def test_tracer_threads_keep_local_nesting():
    tr = Tracer()
    # barrier keeps all workers alive at once so thread ids are distinct
    gate = threading.Barrier(4)

    def worker(i):
        gate.wait()
        with tr.span(f"w{i}"):
            with tr.span(f"w{i}.child"):
                pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tr.events()) == 8
    tids = {e["tid"] for e in tr.events()}
    assert len(tids) == 4


# -- bundle / disabled mode -------------------------------------------------


def test_null_obs_is_shared_noop():
    assert get_obs(None) is NULL_OBS
    assert not NULL_OBS.enabled
    # one shared span object, one shared instrument each — no allocation
    assert NULL_OBS.tracer.span("a") is NULL_OBS.tracer.span("b")
    assert (NULL_OBS.metrics.counter("x")
            is NULL_OBS.metrics.counter("y", l="v"))
    NULL_OBS.metrics.counter("x").inc()
    NULL_OBS.metrics.histogram("h").observe(1.0)
    NULL_OBS.metrics.gauge("g").set(2)
    assert NULL_OBS.metrics.snapshot() == {
        "counters": [], "gauges": [], "histograms": []}
    assert NULL_OBS.metrics.to_prometheus() == ""
    assert NULL_OBS.tracer.events() == []
    with NULL_OBS.tracer.span("nested") as sp:
        assert sp.set(a=1) is sp and sp.sync(None) is sp


def test_enabled_bundle_and_global_install():
    obs = obs_mod.enabled()
    assert obs.enabled
    assert isinstance(obs, Observability)
    try:
        obs_mod.install_global(obs)
        assert obs_mod.global_obs() is obs
    finally:
        obs_mod.install_global(None)
    assert obs_mod.global_obs() is NULL_OBS


def test_cli_helpers(tmp_path):
    ap = argparse.ArgumentParser()
    obs_mod.add_cli_args(ap)
    m_path = tmp_path / "metrics.json"
    t_path = tmp_path / "trace.json"
    args = ap.parse_args(
        ["--metrics-out", str(m_path), "--trace-out", str(t_path)])
    try:
        obs = obs_mod.from_cli_args(args)
        assert obs.enabled
        assert obs_mod.global_obs() is obs
        obs.metrics.counter("repro_mining_launches_total", path="fused").inc()
        with obs.tracer.span("mine.fused"):
            pass
        obs_mod.write_cli_outputs(obs, args)
    finally:
        obs_mod.install_global(None)
    metrics_doc = json.loads(m_path.read_text())
    assert set(metrics_doc) == {"metrics", "prometheus"}
    assert "# TYPE repro_mining_launches_total counter" \
        in metrics_doc["prometheus"]
    trace_doc = json.loads(t_path.read_text())
    assert any(e.get("name") == "mine.fused"
               for e in trace_doc["traceEvents"])
    # no flags → the null bundle, nothing installed, nothing written
    off = ap.parse_args([])
    assert obs_mod.from_cli_args(off) is NULL_OBS
    obs_mod.write_cli_outputs(NULL_OBS, off)


# -- timing helpers ---------------------------------------------------------


def test_stopwatch_and_latency_summary():
    with Stopwatch() as sw:
        live = sw.seconds
    assert 0.0 <= live <= sw.seconds
    frozen = sw.seconds
    assert sw.seconds == frozen  # frozen after exit
    assert sw.ms == pytest.approx(frozen * 1e3)

    lats = [0.001, 0.002, 0.004, 0.010]
    assert percentile_ms([], 50) == 0.0
    assert percentile_ms(lats, 50) == pytest.approx(
        float(np.percentile(np.array(lats) * 1e3, 50)))
    digest = latency_summary(lats)
    assert set(digest) == {"count", "mean_ms", "p50_ms", "p95_ms",
                           "p99_ms", "max_ms"}
    assert digest["count"] == 4
    assert digest["max_ms"] == pytest.approx(10.0)


# -- the port's tracer: span ids, device intervals, device counts -------------
#
# A CUDA span's device interval comes from timing events the card records;
# here a clock on the host's own ``perf_counter`` stands in for it, so the
# bookkeeping (ids, the bound, the export's device track) is tested on the
# CPU.  tests/test_torch_mining_trace.py checks the events on the card.


class _HostClock:
    """A :class:`repro_torch.obs.tracing.DeviceClock` whose events are host
    timestamps, ``lag`` seconds late, complete once ``ready`` says so."""

    lag = 2e-4

    def __init__(self, device):
        import time

        self.device = device
        self.name = str(device)
        self.host0 = time.perf_counter()
        self.ready = lambda event: True

    def stream(self):
        return None

    def mark(self, stream):
        import time

        return time.perf_counter() + self.lag

    def done(self, end):
        return self.ready(end)

    def resolve(self, start, end):
        return (start - self.host0) * 1e3, (end - self.host0) * 1e3

    def calibrate(self):
        pass

    def host_s(self, ms):
        return self.host0 + ms / 1e3


@pytest.fixture
def host_clock(monkeypatch):
    from repro_torch.obs import tracing

    monkeypatch.setattr(tracing, "DeviceClock", _HostClock)
    return _HostClock


def test_torch_span_on_cpu_has_no_device_interval():
    import torch

    from repro_torch.obs.tracing import Tracer

    tr = Tracer()
    with tr.span("mine.step", device=torch.device("cpu"), step=0):
        with tr.span("mine.scan", device="cpu"):
            pass
    host, device = tr.intervals()
    assert [n for n, _, _ in host] == ["mine.scan", "mine.step"]
    assert all(a <= b for _, a, b in host)
    assert device == [] and tr.device_events() == []
    assert not any(e.get("cat") == "repro.device"
                   for e in tr.to_chrome_trace()["traceEvents"])


def test_torch_span_ids_link_children_to_their_step():
    from repro_torch.obs.tracing import Tracer

    tr = Tracer()
    for step in range(2):
        with tr.span("mine.step", step=step):
            with tr.span("mine.scan"):
                pass
            with tr.span("mine.merge"):
                with tr.span("mine.gather", axis="z"):
                    pass
    events = tr.events()
    by_id = {e["args"]["id"]: e for e in events}
    assert len(by_id) == len(events) == 8          # ids are unique
    steps = [e for e in events if e["name"] == "mine.step"]
    assert [s["args"]["step"] for s in steps] == [0, 1]
    for s in steps:
        assert s["args"]["parent"] is None
        assert s["args"]["root"] == s["args"]["id"]
        kids = [e for e in events if e["args"]["root"] == s["args"]["id"]
                and e is not s]
        assert sorted(e["name"] for e in kids) == [
            "mine.gather", "mine.merge", "mine.scan"]
        gather = next(e for e in kids if e["name"] == "mine.gather")
        merge = by_id[gather["args"]["parent"]]
        assert merge["name"] == "mine.merge"
        assert merge["args"]["parent"] == s["args"]["id"]
        for k in kids:   # a child lies inside its step on the host clock
            assert s["ts"] <= k["ts"]
            assert k["ts"] + k["dur"] <= s["ts"] + s["dur"]


def test_torch_chrome_trace_has_the_device_track_on_the_host_clock(
        host_clock):
    from repro_torch.obs.tracing import DEVICE_TID_BASE, Tracer

    tr = Tracer()
    with tr.span("mine.step", device="cuda:0", step=0):
        with tr.span("mine.scan", device="cuda:0"):
            pass
        with tr.span("mine.host_only"):
            pass
    host, device = tr.intervals()
    assert [n for n, _, _ in device] == ["mine.scan", "mine.step"]
    spans = {n: (a, b) for n, a, b in host}
    for name, a, b in device:      # the lag of the stand-in clock
        assert a - spans[name][0] == pytest.approx(host_clock.lag, abs=1e-4)
        assert b - spans[name][1] == pytest.approx(host_clock.lag, abs=1e-4)
    doc = json.loads(json.dumps(tr.to_chrome_trace()))
    events = doc["traceEvents"]
    track = [e for e in events if e.get("cat") == "repro.device"]
    assert {e["tid"] for e in track} == {DEVICE_TID_BASE}
    names = [e for e in events if e["ph"] == "M"
             and e.get("tid") == DEVICE_TID_BASE]
    assert names and names[0]["args"]["name"] == "cuda:0 stream"
    on_host = {e["name"]: e for e in events if e.get("cat") == "repro"}
    for e in track:
        h = on_host[e["name"]]
        assert e["args"]["id"] == h["args"]["id"]
        assert e["pid"] == h["pid"]
        # one ts clock: the device lane starts the lag after the host's
        assert e["ts"] - h["ts"] == pytest.approx(host_clock.lag * 1e6,
                                                  abs=100)


def test_torch_device_intervals_resolve_oldest_first_and_count_in_bound(
        host_clock, monkeypatch):
    from repro_torch.obs import tracing

    monkeypatch.setattr(tracing, "RESOLVE_EVERY", 2)
    tr = tracing.Tracer(max_events=7)
    clock = tr._clock("cuda:0")
    clock.ready = lambda event: False        # nothing has completed yet
    for i in range(2):
        with tr.span(f"s{i}", device="cuda:0"):
            pass
    assert len(tr._pending) == 2 and tr._device == []
    clock.ready = lambda event: True         # the next close takes all 3
    with tr.span("s2", device="cuda:0"):
        pass
    assert len(tr._pending) == 0 and len(tr._device) == 3
    with tr.span("s3", device="cuda:0"):     # 6 held: no room for two
        pass
    with tr.span("s4"):                      # room for one
        pass
    assert tr.dropped == 1
    host, device = tr.intervals()
    assert [n for n, _, _ in host] == ["s0", "s1", "s2", "s4"]
    assert [n for n, _, _ in device] == ["s0", "s1", "s2"]
    assert [a for _, a, _ in device] == sorted(a for _, a, _ in device)


def test_torch_counter_takes_a_device_count():
    import torch

    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    live = reg.counter("repro_mining_live_codes_total", stage="merge")
    for n in (5, 7, 11):
        live.inc(torch.tensor(n, dtype=torch.int32).sum())
    live.inc(2)
    assert live.value == 25
    [row] = reg.snapshot()["counters"]
    assert row == {"name": "repro_mining_live_codes_total",
                   "labels": {"stage": "merge"}, "value": 25}
    assert json.loads(json.dumps(reg.snapshot())) == reg.snapshot()
    assert ('repro_mining_live_codes_total{stage="merge"} 25'
            in reg.to_prometheus())


def test_torch_null_tracer_records_nothing():
    from repro_torch.obs import NULL_OBS
    from repro_torch.obs.tracing import NULL_TRACER

    a = NULL_TRACER.span("mine.step", device="cuda:0", step=0)
    assert a is NULL_TRACER.span("mine.scan", device="cpu")
    with a as sp:
        with NULL_TRACER.span("mine.fold", device="cuda:0"):
            assert sp.set(rows=1) is sp
    assert NULL_TRACER.events() == [] and NULL_TRACER.device_events() == []
    assert NULL_TRACER.intervals() == ([], [])
    assert NULL_OBS.tracer is NULL_TRACER
    assert NULL_TRACER.to_chrome_trace()["traceEvents"] == []
