"""The port's motif service against the JAX package.

Every case of the JAX package's ``tests/test_motif_service.py`` is
mirrored on the port's service (``device="cpu"``; ``backend="cuda"``, so
the kernels' plain versions, unless a case names the ``numpy`` oracle),
with the JAX package's batch ``discover`` on each tenant's closed prefix
as the expected answer: interleaved tenants, the admission window, the
epoch cache, threaded tenants, drop races, and a first query of an epoch
that does not stall ingest.  The port's :class:`QueryEngine` answers every
op as the JAX one does on the same snapshot, co-mining equals JAX
``discover`` per tenant, and ``serve_motifs`` verifies its tenants.

Tolerance: none.  Counts, histograms, top-k lists and prefix counts are
compared exactly; transition shares are the same float divisions of the
same integers, so they are compared exactly too.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.core import oracle
from repro.core.temporal_graph import TemporalGraph
from repro.serving.motif import QueryEngine as JaxQueryEngine
from repro_torch.core import MiningConfig, PTMTEngine
from repro_torch.core.api import DiscoveryResult
from repro_torch.core.streaming import StreamingMiner
from repro_torch.kernels.zone_scan import ops as scan_ops
from repro_torch.serving.motif import (
    EpochCache,
    MotifService,
    MotifSession,
    QueryEngine,
    QueryRequest,
    SessionManager,
)
from conftest import random_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA, L_MAX, OMEGA = 20, 4, 3


def closed_prefix(g: TemporalGraph, closed_time: int) -> TemporalGraph:
    cut = int(np.searchsorted(g.t, closed_time, side="left"))
    return TemporalGraph(u=g.u[:cut], v=g.v[:cut], t=g.t[:cut],
                         n_nodes=g.n_nodes)


def jax_batch(g, **kw):
    params = dict(delta=DELTA, l_max=L_MAX, omega=OMEGA)
    params.update(kw)
    return JaxEngine(JaxConfig(**params)).discover(g)


def make_service(**kw):
    params = dict(delta=DELTA, l_max=L_MAX, omega=OMEGA, backend="cuda",
                  device="cpu")
    params.update(kw)
    return MotifService(**params)


def assert_queries_match_batch(service, name, g):
    """Every query op agrees with JAX batch discover on the closed prefix."""
    sess = service.manager.get(name)
    expect = jax_batch(closed_prefix(g, sess.closed_time))
    tree = expect.tree()

    engine = sess.engine()
    assert engine.result.counts == expect.counts

    hist = service.query(QueryRequest(session=name, op="level_histogram"))
    assert hist.payload == expect.level_histogram()

    total = service.query(QueryRequest(session=name, op="total"))
    assert total.payload == expect.total_processes()

    for level in range(1, L_MAX + 1):
        top = service.query(
            QueryRequest(session=name, op="top_k", level=level, k=5))
        want = sorted(
            ((c, n) for c, n in expect.counts.items()
             if len(c) // 2 == level),
            key=lambda kv: (-kv[1], kv[0]))[:5]
        assert top.payload == want

    for code in list(expect.counts)[:10]:
        for lvl in range(2, len(code) + 1, 2):
            prefix = code[:lvl]
            cnt = service.query(
                QueryRequest(session=name, op="prefix_count", code=prefix))
            assert cnt.payload == tree.node(prefix).through
            probs = service.query(QueryRequest(
                session=name, op="transition_probs", code=prefix))
            want_rows = tree.node(prefix).transition_rows()
            assert [(r.code, r.count, r.share) for r in probs.payload] \
                == want_rows
            if want_rows:
                assert sum(r.share for r in probs.payload) \
                    == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The JAX package's tests/test_motif_service.py, case for case.
# ---------------------------------------------------------------------------


def test_interleaved_ingest_query_two_tenants_matches_batch():
    graphs = {"a": random_graph(5, 600, 11, 2_200),
              "b": random_graph(13, 500, 9, 1_800)}
    service = make_service(ingest_batch=1)       # admit every chunk
    for name in graphs:
        service.create_session(name)

    chunk = 120
    for i in range(0, 600, chunk):
        for name, g in graphs.items():
            service.ingest(name, g.u[i:i + chunk], g.v[i:i + chunk],
                           g.t[i:i + chunk])
        # between chunks the JAX package's brute-force oracle is the
        # expected value (batch discover equals it, and is held at the end)
        for name, g in graphs.items():
            sess = service.manager.get(name)
            if sess.closed_time is None:
                continue
            p = closed_prefix(g, sess.closed_time)
            expect = dict(oracle.count_codes(p.u, p.v, p.t, DELTA, L_MAX))
            assert sess.engine().result.counts == expect, \
                f"{name} at edge {i}"

    for name, g in graphs.items():
        assert_queries_match_batch(service, name, g)


def test_batched_admission_defers_then_matches():
    g = random_graph(3, 400, 8, 1_500)
    service = make_service(ingest_batch=10_000)  # never auto-flush
    service.create_session("a")
    for i in range(0, g.n_edges, 37):
        ack = service.ingest("a", g.u[i:i + 37], g.v[i:i + 37],
                             g.t[i:i + 37])
        assert not ack.flushed
    sess = service.manager.get("a")
    assert sess.pending_edges == g.n_edges
    assert sess.miner.n_edges_ingested == 0
    assert sess.epoch == 0

    ack = service.flush("a")
    assert ack.flushed and ack.accepted == g.n_edges
    assert sess.pending_edges == 0
    assert sess.miner.n_edges_ingested == g.n_edges
    assert sess.flushes == 1
    assert_queries_match_batch(service, "a", g)


def test_admission_window_repairs_local_disorder():
    service = make_service(ingest_batch=10_000)
    service.create_session("a")
    service.ingest("a", [0, 1], [1, 2], [50, 40])     # locally out of order
    service.ingest("a", [2, 3], [3, 4], [10, 60])
    service.flush("a")
    sess = service.manager.get("a")
    assert sess.miner.n_edges_ingested == 4
    assert sess.miner.snapshot(final=True).total_processes() == 4


def test_rejected_flush_keeps_admission_buffer():
    service = make_service(ingest_batch=10_000)
    service.create_session("a")
    service.ingest("a", [0, 1], [1, 2], [100, 200])
    service.flush("a")
    sess = service.manager.get("a")
    service.ingest("a", np.arange(9), np.arange(1, 10),
                   np.arange(300, 309))
    service.ingest("a", [9], [10], [50])         # older than the head
    with pytest.raises(ValueError, match="time-ordered"):
        service.flush("a")
    assert sess.pending_edges == 10              # nothing silently dropped
    assert sess.miner.n_edges_ingested == 2

    assert service.discard_pending("a") == 10
    assert sess.pending_edges == 0
    service.ingest("a", [20], [21], [400])
    service.flush("a")
    assert sess.miner.n_edges_ingested == 3
    assert sess.stats()["edges_discarded"] == 10


def test_ingest_rejects_chunks_that_would_wrap():
    service = make_service(ingest_batch=10_000)
    service.create_session("a")
    with pytest.raises(ValueError, match="integer-typed"):
        service.ingest("a", [0.5], [1], [5])
    with pytest.raises(ValueError, match="outside int32"):
        service.ingest("a", [2**31], [1], [5])
    assert service.manager.get("a").pending_edges == 0


def test_cache_hit_no_remine_within_epoch():
    g = random_graph(9, 500, 10, 2_000)
    service = make_service(ingest_batch=1)
    service.create_session("a")
    service.ingest("a", g.u[:400], g.v[:400], g.t[:400])
    sess = service.manager.get("a")

    for _ in range(5):
        service.query(QueryRequest(session="a", op="level_histogram"))
        service.query(QueryRequest(session="a", op="top_k", level=1))
    stats = sess.stats()
    assert stats["snapshots_mined"] == 1
    assert stats["cache"]["hits"] == 9
    epoch_before = sess.epoch

    service.ingest("a", g.u[400:], g.v[400:], g.t[400:])
    assert sess.epoch > epoch_before
    for _ in range(3):
        service.query(QueryRequest(session="a", op="total"))
    stats = sess.stats()
    assert stats["snapshots_mined"] == 2
    assert stats["cache"]["hits"] == 9 + 2


def test_epoch_bumps_only_when_closed_prefix_changes():
    miner = StreamingMiner(delta=10, l_max=2, omega=2, device="cpu")
    assert miner.epoch == 0
    miner.ingest([0], [1], [100])
    e1 = miner.epoch
    assert e1 == 1                               # closed_time appeared
    miner.ingest([1], [2], [100])                # same t_head, no finalize
    assert miner.epoch == e1
    miner.ingest([2], [3], [500])                # head advances
    assert miner.epoch > e1


def test_query_response_protocol_fields():
    g = random_graph(2, 300, 7, 1_000)
    service = make_service(ingest_batch=1)
    service.create_session("a")
    service.ingest("a", g.u, g.v, g.t)
    sess = service.manager.get("a")
    resp = service.query(QueryRequest(session="a", op="prefix_count",
                                      code="01"))
    assert resp.session == "a"
    assert resp.op == "prefix_count"
    assert resp.epoch == sess.epoch
    assert resp.latency_s >= 0.0
    assert isinstance(resp.payload, int)
    assert resp.first_call
    assert not service.query(QueryRequest(session="a", op="prefix_count",
                                          code="01")).first_call

    with pytest.raises(ValueError, match="unknown op"):
        service.query(QueryRequest(session="a", op="nope"))
    with pytest.raises(KeyError, match="unknown session"):
        service.query(QueryRequest(session="ghost", op="total"))
    with pytest.raises(ValueError, match="odd length"):
        service.query(QueryRequest(session="a", op="prefix_count", code="0"))
    for code in ("ee", "ff", "zz", "01" * 8):
        empty = service.query(QueryRequest(
            session="a", op="transition_probs", code=code))
        assert empty.payload == []
        zero = service.query(QueryRequest(session="a", op="prefix_count",
                                          code=code))
        assert zero.payload == 0


def test_session_manager_lifecycle():
    manager = SessionManager(max_sessions=2, delta=DELTA, l_max=L_MAX,
                             omega=OMEGA, device="cpu")
    manager.create("a")
    manager.create("b", delta=50)                # per-tenant override
    assert manager.get("b").miner.delta == 50
    assert manager.names() == ["a", "b"]
    with pytest.raises(ValueError, match="already exists"):
        manager.create("a")
    with pytest.raises(RuntimeError, match="session limit"):
        manager.create("c")
    manager.drop("a")
    manager.create("c")
    with pytest.raises(KeyError, match="unknown session"):
        manager.get("a")
    assert manager.stats()["n_sessions"] == 2
    # a failed construction releases its reservation
    manager.drop("c")
    with pytest.raises(ValueError):
        manager.create("d", delta=0)
    manager.create("d")
    assert manager.names() == ["b", "d"]


def test_epoch_cache_lru_and_stats():
    cache = EpochCache(capacity=2)
    assert cache.get(0) is None
    cache.put(0, "e0")
    cache.put(1, "e1")
    assert cache.get(0) == "e0"                  # refreshes LRU order
    cache.put(2, "e2")                           # evicts epoch 1
    assert cache.get(1) is None
    assert cache.get(0) == "e0"
    assert cache.peek(2) == "e2"                 # uncounted
    assert cache.stats() == {"hits": 2, "misses": 2, "evictions": 1,
                             "entries": 2}
    with pytest.raises(ValueError):
        EpochCache(capacity=0)


def test_concurrent_tenants_threaded():
    """Ingest and query threads race across two sessions while hammer
    threads pound the same metrics registry; every increment lands, the
    query histograms count every query, and the final served state equals
    JAX batch discover per tenant."""
    import repro_torch.obs as obs_mod

    graphs = {"a": random_graph(21, 400, 8, 1_500),
              "b": random_graph(22, 400, 8, 1_500)}
    obs = obs_mod.enabled()
    service = make_service(backend="numpy", ingest_batch=64, obs=obs)
    for name in graphs:
        service.create_session(name)

    errors: list[Exception] = []
    done = threading.Event()
    n_queries: dict[str, int] = {}

    def ingester(name, g):
        try:
            for i in range(0, g.n_edges, 50):
                service.ingest(name, g.u[i:i + 50], g.v[i:i + 50],
                               g.t[i:i + 50])
        except Exception as exc:                 # pragma: no cover
            errors.append(exc)

    def querier(name):
        served = 0
        try:
            while not done.is_set():
                r = service.query(
                    QueryRequest(session=name, op="level_histogram"))
                assert isinstance(r.payload, dict)
                r = service.query(
                    QueryRequest(session=name, op="prefix_count", code="01"))
                assert r.payload >= 0
                served += 2
        except Exception as exc:                 # pragma: no cover
            errors.append(exc)
        n_queries[name] = served

    HAMMER_ITERS, HAMMER_THREADS = 4_000, 4

    def hammer(worker):
        try:
            c = obs.metrics.counter("test_hammer_total")
            h = obs.metrics.histogram("test_hammer_ms")
            g_ = obs.metrics.gauge("test_hammer_gauge", worker=str(worker))
            for k in range(HAMMER_ITERS):
                c.inc()
                h.observe(float(k % 7))
                g_.set(k)
        except Exception as exc:                 # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=ingester, args=(n, g))
               for n, g in graphs.items()]
    threads += [threading.Thread(target=querier, args=(n,)) for n in graphs]
    threads += [threading.Thread(target=hammer, args=(i,))
                for i in range(HAMMER_THREADS)]
    for t in threads:
        t.start()
    for t in threads[:2]:
        t.join(60)
    done.set()
    for t in threads[2:]:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors

    total = HAMMER_ITERS * HAMMER_THREADS
    assert obs.metrics.counter("test_hammer_total").value == total
    assert obs.metrics.find("test_hammer_ms").count == total
    recorded = sum(
        inst.count for inst in obs.metrics.instruments()
        if inst.name in ("repro_serving_query_latency_ms",
                         "repro_serving_query_first_call_ms"))
    assert recorded == sum(n_queries.values())
    for name in graphs:
        service.query(QueryRequest(session=name, op="level_histogram"))
        service.query(QueryRequest(session=name, op="level_histogram"))
    snap = obs.metrics.snapshot()
    assert any(c["name"] == "test_hammer_total" for c in snap["counters"])
    prom = obs.metrics.to_prometheus()
    assert "# TYPE test_hammer_total counter" in prom
    assert "# TYPE repro_serving_query_latency_ms histogram" in prom

    for name, g in graphs.items():
        service.flush(name)
        assert_queries_match_batch(service, name, g)


def test_drop_races_concurrent_ingest_and_query():
    g = random_graph(33, 1_200, 10, 4_000)
    service = make_service(backend="numpy", ingest_batch=32)
    service.create_session("t")
    service.ingest("t", g.u[:300], g.v[:300], g.t[:300])
    service.flush("t")

    errors: list[Exception] = []
    dropped = threading.Event()

    def ingester():
        try:
            for i in range(300, g.n_edges, 30):
                service.ingest("t", g.u[i:i + 30], g.v[i:i + 30],
                               g.t[i:i + 30])
        except KeyError:
            pass                                 # dropped under our feet
        except Exception as exc:                 # pragma: no cover
            errors.append(exc)

    def querier():
        try:
            while not dropped.is_set():
                try:
                    r = service.query(QueryRequest(session="t", op="total"))
                    assert r.payload >= 0
                except KeyError:
                    break                        # dropped under our feet
        except Exception as exc:                 # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=ingester),
               threading.Thread(target=querier)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    sess = service.drop_session("t")
    dropped.set()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert "t" not in service.sessions()
    with pytest.raises(KeyError):
        service.query(QueryRequest(session="t", op="total"))

    sess.flush()
    expect = jax_batch(closed_prefix(g, sess.closed_time))
    assert sess.engine().result.counts == expect.counts
    service.create_session("t")


def test_restore_respects_max_sessions():
    manager = SessionManager(max_sessions=1, delta=DELTA, l_max=L_MAX,
                             omega=OMEGA, device="cpu")
    manager.create("a")
    state = dict(manager.get("a").checkpoint_state(), name="b")
    with pytest.raises(RuntimeError, match="session limit"):
        manager.restore(state)


def test_comine_with_tenant_dropped_mid_call():
    g = random_graph(35, 300, 8, 1_000)
    service = make_service(ingest_batch=64)
    service.create_session("a")
    service.create_session("b")
    service.drop_session("b")
    with pytest.raises(KeyError, match="unknown session"):
        service.comine(g, ["a", "b"])

    manager = service.manager
    real_names = manager.names
    manager.names = lambda: real_names() + ["ghost"]
    try:
        results = service.comine(g)
    finally:
        manager.names = real_names
    assert sorted(results) == ["a"]
    assert results["a"].counts == jax_batch(g).counts


def test_first_query_of_epoch_does_not_stall_ingest():
    """The cold-epoch snapshot mine runs outside the session lock: with
    the mine held open, a concurrent ingest and flush complete."""
    g = random_graph(37, 600, 10, 2_000)
    service = make_service(ingest_batch=64)
    service.create_session("t")
    service.ingest("t", g.u[:300], g.v[:300], g.t[:300])
    sess = service.manager.get("t")

    real_mine = sess.miner.mine_view
    in_mine = threading.Event()
    release = threading.Event()

    def held_mine(view):
        in_mine.set()
        assert release.wait(10), "test harness never released the mine"
        return real_mine(view)

    sess.miner.mine_view = held_mine
    resp: dict = {}

    def query():
        resp["r"] = service.query(QueryRequest(session="t", op="total"))

    qt = threading.Thread(target=query)
    qt.start()
    assert in_mine.wait(10), "query never reached the snapshot mine"

    ingested = threading.Event()

    def ingest():
        service.ingest("t", g.u[300:], g.v[300:], g.t[300:])
        service.flush("t")
        ingested.set()

    it = threading.Thread(target=ingest)
    it.start()
    assert ingested.wait(10), \
        "ingest stalled behind the first query of the epoch"
    assert not resp, "query returned before its mine was released"
    release.set()
    qt.join(10)
    it.join(10)
    assert not qt.is_alive() and not it.is_alive()
    sess.miner.mine_view = real_mine

    assert resp["r"].payload >= 0
    assert_queries_match_batch(service, "t", g)


# ---------------------------------------------------------------------------
# The port's own surface: queries against the JAX QueryEngine, co-mining,
# devices, thread-safe launch counts, the serving CLI.
# ---------------------------------------------------------------------------


def test_query_engine_answers_like_jax():
    """Both packages' query engines over one count table answer every op
    the same way, valid and unobservable codes alike."""
    res = jax_batch(random_graph(41, 700, 9, 2_400))
    port = QueryEngine(DiscoveryResult(
        counts=dict(res.counts), n_zones=res.n_zones, e_cap=res.e_cap,
        overflow=0, delta=res.delta, l_max=res.l_max), epoch=3)
    jax = JaxQueryEngine(res, epoch=3)
    codes = ["", "01", "0102", "ee", "zz", "01" * 8] + list(res.counts)
    for level in (None, 1, 2, 3, 4):
        assert port.top_k_motifs(level=level, k=7) == \
            jax.top_k_motifs(level=level, k=7)
    for code in codes:
        assert port.prefix_count(code) == jax.prefix_count(code), code
        assert [tuple(r.__dict__.values())
                for r in port.transition_probs(code)] == \
            [tuple(r.__dict__.values())
             for r in jax.transition_probs(code)], code
    assert port.level_histogram() == jax.level_histogram()
    assert port.total_processes() == jax.total_processes()
    with pytest.raises(ValueError, match="k must be"):
        port.top_k_motifs(k=0)


def test_comine_fallback_engine_runs_on_the_sessions_device():
    """Config-built tenants share no engine: the manager builds its
    co-mining engine on the device of the tenants' executors (the CPU
    here, where a default engine would raise for want of CUDA), and the
    tenants' lattice equals JAX discover per config."""
    g = random_graph(43, 500, 10, 1_800)
    cfg = MiningConfig(delta=DELTA, l_max=L_MAX, omega=OMEGA,
                       backend="cuda")
    service = MotifService(config=cfg, device="cpu")
    service.create_session("a")
    service.create_session("b", config=cfg.with_updates(delta=DELTA // 2,
                                                        l_max=3))
    results = service.comine(g)
    assert service.manager._comine_engine.device == torch.device("cpu")
    assert results["a"].counts == jax_batch(g).counts
    assert results["b"].counts == jax_batch(g, delta=DELTA // 2,
                                            l_max=3).counts


def test_service_and_sessions_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    service = MotifService(delta=DELTA, l_max=L_MAX)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.create_session("a")
    assert service.sessions() == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotifSession("a", config=MiningConfig(delta=DELTA, l_max=L_MAX))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotifService(engine=PTMTEngine(MiningConfig(backend="cuda")))


def test_session_shares_its_engine_and_device():
    engine = PTMTEngine(MiningConfig(delta=DELTA, l_max=L_MAX,
                                     backend="cuda"), device="cpu")
    sess = MotifSession("a", engine=engine)
    assert sess.miner.executor is engine.executor
    assert sess.mining_engine is engine
    assert sess.miner.executor.device == torch.device("cpu")
    with pytest.raises(ValueError, match="its own device"):
        MotifSession("b", engine=engine, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        MotifSession("c", engine=engine, config=engine.config)


def test_launch_counts_are_exact_under_threads():
    """Serving mines from several threads; every counted launch lands."""
    n_threads, per_thread = 16, 2_000
    scan_ops.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [scan_ops._count_launch("zone_scan_dense")
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert scan_ops.launches["zone_scan_dense"] == n_threads * per_thread
    scan_ops.reset_launches()


def test_serve_motifs_cli_verifies_every_tenant(tmp_path):
    """The single-service driver on the CPU: each tenant's served counts
    equal batch discover on its closed prefix (``--verify``)."""
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_motifs",
         "--device", "cpu", "--backend", "cuda", "--dataset",
         "collegemsg-like", "--delta", "60", "--l-max", "3", "--tenants",
         "2", "--chunk-edges", "1024", "--ingest-batch", "2048",
         "--queries-per-chunk", "2", "--verify", "--out-json", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.count("exact match on closed prefix") == 2
    import json

    report = json.load(open(out))
    assert report["tenants"] == 2 and report["edges"] == 20_000
    assert report["snapshots_mined"] > 0
    assert set(report["per_op"]) == {"level_histogram", "prefix_count",
                                     "top_k", "transition_probs"}
