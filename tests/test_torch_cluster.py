"""The port's cluster layer against the JAX package.

Every case of the JAX package's ``tests/test_cluster.py`` is mirrored on
the port (``device="cpu"``, ``backend="cuda"``, so the kernels' plain
versions), with the JAX package's uninterrupted replay (or its batch
``discover``) as the expected counts: checkpoint round trips and
corruption checks, rendezvous placement, admission budgets, failover, a
cold restart and the kill/restart harness.  The JAX case that shards over
a JAX mesh runs on a one-rank gloo ``DeviceMesh``.

The checkpoint format is shared: with ``backend="ref"`` the file the port
writes for a stream is byte-identical to the JAX package's, and a
checkpoint written by either package restores in the other and finishes
with the same counts.  Those cases run ``ref``, a backend both packages
have (a checkpoint restores only into its own config and tail-layout
signature), without a memory budget (with one, the ``cuda`` memory model
derives other zone chunks than the JAX package by design).  A checkpoint
naming a backend the port lacks (``pallas``) fails with an error naming
it.

Tolerance: none; every count table is compared exactly.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro.core import MiningConfig as JaxConfig
from repro.core import PTMTEngine as JaxEngine
from repro.serving import cluster as jax_cluster
from repro.serving.motif import MotifService as JaxService
from repro.serving.motif import MotifSession as JaxSession
from repro_torch.core import MiningConfig, PTMTEngine
from repro_torch.serving.cluster import (
    AdmissionController,
    CheckpointError,
    CheckpointStore,
    ClusterCoordinator,
    SessionCheckpoint,
    WorkerDown,
    checkpoint,
    place,
    rendezvous_owner,
)
from repro_torch.serving.motif import MotifService, MotifSession, QueryRequest
from conftest import random_graph
from torch_corpus import gloo_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA, L_MAX, OMEGA = 20, 4, 3


def _cfg(**kw):
    params = dict(delta=DELTA, l_max=L_MAX, omega=OMEGA, backend="cuda")
    params.update(kw)
    return MiningConfig(**params)


def _jax_cfg(**kw):
    params = dict(delta=DELTA, l_max=L_MAX, omega=OMEGA, backend="ref")
    params.update(kw)
    return JaxConfig(**params)


def _engine(cfg=None):
    return PTMTEngine(cfg or _cfg(), device="cpu")


def _coordinator(n, **kw):
    kw.setdefault("config", _cfg())
    return ClusterCoordinator(n, device="cpu", **kw)


def _feed(target, name, g, *, chunk, start=0, end=None):
    end = g.n_edges if end is None else end
    i = start
    while i < end:
        j = min(i + chunk, end)
        ack = target.ingest(name, g.u[i:j], g.v[i:j], g.t[i:j])
        if getattr(ack, "throttled", False):
            target.flush(name)
            continue
        i = j
    return i


def _counts(service_or_session, name=None):
    sess = (service_or_session.manager.get(name)
            if name is not None else service_or_session)
    return sess.engine().result.counts


def _reference(g, *, chunk=200, ingest_batch=256):
    """The JAX package's uninterrupted replay of ``g``."""
    svc = JaxService(engine=JaxEngine(_jax_cfg()), ingest_batch=ingest_batch)
    svc.create_session("ref")
    _feed(svc, "ref", g, chunk=chunk)
    svc.flush("ref")
    return _counts(svc, "ref")


# ---------------------------------------------------------------------------
# Checkpoint format: round-trip exactness, atomicity, corruption rejection.
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_restores_byte_identical_counts(tmp_path):
    g = random_graph(3, 600, 12, 2_000)
    svc = MotifService(engine=_engine(), ingest_batch=128)
    svc.create_session("alice")
    cut = 300
    _feed(svc, "alice", g, chunk=100, end=cut)

    ckpt = SessionCheckpoint.capture(svc.manager.get("alice"),
                                     {"offset": cut})
    path = ckpt.save(str(tmp_path / "alice.ckpt.json"))
    loaded = SessionCheckpoint.load(path)
    assert loaded.tenant == "alice"
    assert loaded.meta == {"offset": cut}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    svc2 = MotifService(engine=_engine(), ingest_batch=128)
    restored = svc2.manager.restore(loaded.payload)
    assert restored.pending_edges == svc.manager.get("alice").pending_edges
    _feed(svc2, "alice", g, chunk=100, start=cut)
    svc2.flush("alice")

    _feed(svc, "alice", g, chunk=100, start=cut)
    svc.flush("alice")
    assert _counts(svc2, "alice") == _counts(svc, "alice")
    assert _counts(svc2, "alice") == _reference(g)


def test_checkpoint_restore_shares_warm_engine_when_configs_agree():
    engine = _engine()
    svc = MotifService(engine=engine, ingest_batch=64)
    svc.create_session("t")
    g = random_graph(1, 200, 8, 800)
    _feed(svc, "t", g, chunk=64)
    state = svc.manager.get("t").checkpoint_state()

    svc2 = MotifService(engine=engine, ingest_batch=64)
    restored = svc2.manager.restore(state)
    assert restored.miner.executor is engine.executor


def test_checkpoint_rejects_crc_corruption(tmp_path):
    g = random_graph(5, 120, 6, 500)
    svc = MotifService(engine=_engine(), ingest_batch=32)
    svc.create_session("x")
    _feed(svc, "x", g, chunk=40)
    path = str(tmp_path / "x.ckpt.json")
    SessionCheckpoint.capture(svc.manager.get("x")).save(path)

    doc = json.load(open(path))
    doc["payload"]["edges_accepted"] = 10_000
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(CheckpointError, match="CRC"):
        SessionCheckpoint.load(path)

    open(path, "w").write("{not json")
    with pytest.raises(CheckpointError, match="JSON"):
        SessionCheckpoint.load(path)
    with pytest.raises(CheckpointError, match="cannot read"):
        SessionCheckpoint.load(str(tmp_path / "missing.json"))


def test_checkpoint_rejects_unknown_version_and_format(tmp_path):
    svc = MotifService(engine=_engine(), ingest_batch=32)
    svc.create_session("x")
    path = str(tmp_path / "x.ckpt.json")
    SessionCheckpoint.capture(svc.manager.get("x")).save(path)
    doc = json.load(open(path))
    open(path, "w").write(json.dumps(dict(doc, version=99)))
    with pytest.raises(CheckpointError, match="version"):
        SessionCheckpoint.load(path)
    open(path, "w").write(json.dumps(dict(doc, format="something-else")))
    with pytest.raises(CheckpointError, match="format"):
        SessionCheckpoint.load(path)


def test_restore_state_rejects_mismatched_session():
    g = random_graph(7, 150, 8, 600)
    svc = MotifService(engine=_engine(), ingest_batch=32)
    svc.create_session("t")
    _feed(svc, "t", g, chunk=50)
    state = svc.manager.get("t").checkpoint_state()
    with pytest.raises(ValueError, match="does not match"):
        MotifSession("t", config=_cfg(delta=DELTA + 5),
                     device="cpu").restore_state(state)
    with pytest.raises(ValueError, match="tenant"):
        MotifSession("other", config=_cfg(),
                     device="cpu").restore_state(state)
    svc2 = MotifService(config=_cfg(delta=DELTA + 5), device="cpu",
                        ingest_batch=32)
    restored = svc2.manager.restore(state)
    assert restored.config.delta == DELTA


def test_checkpoint_store_tenant_files(tmp_path):
    store = CheckpointStore(str(tmp_path))
    svc = MotifService(engine=_engine(), ingest_batch=32)
    for name in ("a", "weird/name:x", "a" * 80):
        svc.create_session(name)
        store.save(SessionCheckpoint.capture(svc.manager.get(name)))
    assert store.tenants() == sorted(["a", "weird/name:x", "a" * 80])
    assert store.load("weird/name:x").tenant == "weird/name:x"
    assert store.delete("a") and not store.delete("a")
    with pytest.raises(CheckpointError, match="no checkpoint"):
        store.load("a")
    # the file names are the JAX package's
    assert sorted(os.listdir(tmp_path)) == sorted(
        jax_cluster.checkpoint._filename(n) for n in
        ("weird/name:x", "a" * 80))


# ---------------------------------------------------------------------------
# One checkpoint format for both packages.
# ---------------------------------------------------------------------------


def _both_services(ingest_batch=128):
    port = MotifService(engine=PTMTEngine(MiningConfig(**_jax_cfg()
                                                       .to_dict()),
                                          device="cpu"),
                        ingest_batch=ingest_batch)
    jax = JaxService(engine=JaxEngine(_jax_cfg()), ingest_batch=ingest_batch)
    for svc in (port, jax):
        svc.create_session("alice")
    return port, jax


@pytest.mark.parametrize("cut", [0, 250, 700])
def test_checkpoint_file_is_byte_identical_to_jax(tmp_path, cut):
    g = random_graph(3, 700, 12, 2_400)
    port, jax = _both_services()
    for svc in (port, jax):
        _feed(svc, "alice", g, chunk=100, end=cut)
    meta = {"offset": cut}
    p = SessionCheckpoint.capture(port.manager.get("alice"), meta).save(
        str(tmp_path / "port.json"))
    j = jax_cluster.SessionCheckpoint.capture(
        jax.manager.get("alice"), meta).save(str(tmp_path / "jax.json"))
    assert open(p, "rb").read() == open(j, "rb").read()
    assert checkpoint.FORMAT_NAME == jax_cluster.checkpoint.FORMAT_NAME
    assert checkpoint.FORMAT_VERSION == jax_cluster.FORMAT_VERSION


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    """Written by one package mid-stream, restored by the other, fed the
    rest: the same counts as the writer's uninterrupted run."""
    g = random_graph(11, 700, 12, 2_400)
    port, jax = _both_services()
    writer, reader_cls = ((jax, "port") if direction == "jax->port"
                          else (port, "jax"))
    cut = 350
    _feed(writer, "alice", g, chunk=100, end=cut)
    save_cls = (jax_cluster.SessionCheckpoint if writer is jax
                else SessionCheckpoint)
    path = save_cls.capture(writer.manager.get("alice"),
                            {"offset": cut}).save(str(tmp_path / "a.json"))
    if reader_cls == "port":
        reader = MotifService(engine=PTMTEngine(
            MiningConfig(**_jax_cfg().to_dict()), device="cpu"),
            ingest_batch=128)
        ckpt = SessionCheckpoint.load(path)
    else:
        reader = JaxService(engine=JaxEngine(_jax_cfg()), ingest_batch=128)
        ckpt = jax_cluster.SessionCheckpoint.load(path)
    reader.manager.restore(ckpt.payload)
    _feed(reader, "alice", g, chunk=100, start=int(ckpt.meta["offset"]))
    reader.flush("alice")
    _feed(writer, "alice", g, chunk=100, start=cut)
    writer.flush("alice")
    assert _counts(reader, "alice") == _counts(writer, "alice")


def test_pallas_checkpoint_fails_naming_its_backend(tmp_path):
    """A JAX checkpoint on its accelerator backend has no counterpart
    here: restoring it raises, naming ``pallas``, instead of mining on
    another backend."""
    jax = JaxSession("t", config=_jax_cfg(backend="pallas"),
                     ingest_batch=10_000)
    jax.ingest([0, 1, 2], [1, 2, 3], [10, 20, 30])
    path = jax_cluster.CheckpointStore(str(tmp_path)).save(
        jax_cluster.SessionCheckpoint.capture(jax))
    ckpt = SessionCheckpoint.load(path)
    assert ckpt.payload["miner"]["config"]["backend"] == "pallas"
    svc = MotifService(config=_cfg(), device="cpu")
    with pytest.raises(ValueError, match="backend 'pallas'"):
        svc.manager.restore(ckpt.payload)
    assert svc.sessions() == []
    co = _coordinator(1, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="'pallas'"):
        co.restore_all()


# ---------------------------------------------------------------------------
# Rendezvous placement.
# ---------------------------------------------------------------------------


def test_rendezvous_is_deterministic_and_moves_minimally():
    tenants = [f"tenant{i}" for i in range(60)]
    workers = ["w0", "w1", "w2", "w3"]
    before = place(tenants, workers)
    assert before == place(tenants, workers)
    assert before == jax_cluster.place(tenants, workers)
    assert set(before.values()) == set(workers)

    survivors = [w for w in workers if w != "w2"]
    after = place(tenants, survivors)
    for t in tenants:
        if before[t] != "w2":
            assert after[t] == before[t]
        else:
            assert after[t] in survivors


def test_rendezvous_requires_workers():
    with pytest.raises(ValueError, match="no live workers"):
        rendezvous_owner("t", [])


# ---------------------------------------------------------------------------
# Admission control.
# ---------------------------------------------------------------------------


def test_admission_tenant_and_global_budgets():
    adm = AdmissionController(tenant_budget=100, global_budget=150)
    assert adm.offer("a", 80)
    d = adm.offer("a", 30)
    assert not d and d.reason == "tenant_budget"
    assert adm.offer("b", 60)
    d = adm.offer("b", 20)
    assert not d and d.reason == "global_budget"
    assert adm.deferred_edges == 50
    adm.settle("a", 0)
    assert adm.offer("b", 20)
    assert adm.pending() == 80
    with pytest.raises(ValueError, match="tenant_budget"):
        AdmissionController(tenant_budget=0)


def test_admission_settle_and_forget_reconcile_debt():
    adm = AdmissionController(tenant_budget=50, global_budget=None)
    adm.offer("a", 40)
    adm.settle("a", 10)
    assert adm.pending("a") == 10 and adm.pending() == 10
    adm.offer("a", 40)
    adm.forget("a")
    assert adm.pending() == 0
    adm.shed("a", 7)
    assert adm.stats()["shed_edges"] == 7


def test_admission_throttles_cluster_ingest_without_buffering():
    g = random_graph(11, 400, 10, 1_500)
    co = _coordinator(1, tenant_budget=100, ingest_batch=10_000)
    co.create_tenant("t")
    ack = co.ingest("t", g.u[:80], g.v[:80], g.t[:80])
    assert not ack.throttled and ack.pending == 80
    ack = co.ingest("t", g.u[80:160], g.v[80:160], g.t[80:160])
    assert ack.throttled and ack.reason == "tenant_budget"
    assert ack.accepted == 0
    assert co.workers["w0"].service.manager.get("t").pending_edges == 80
    co.flush("t")
    ack = co.ingest("t", g.u[80:160], g.v[80:160], g.t[80:160])
    assert not ack.throttled


# ---------------------------------------------------------------------------
# Coordinator: routing, failover, cold restart.
# ---------------------------------------------------------------------------


def test_failover_restores_byte_identical_counts(tmp_path):
    g = random_graph(13, 700, 14, 2_500)
    co = _coordinator(3, checkpoint_dir=str(tmp_path), ingest_batch=128)
    names = [f"tenant{i}" for i in range(4)]
    for n in names:
        co.create_tenant(n)
        co.checkpoint(n, {"offset": 0})
    offsets = {n: _feed(co, n, g, chunk=100, end=400) for n in names}
    co.checkpoint_all({n: {"offset": offsets[n]} for n in names})

    victim = co.owner_of(names[0])
    recovered = co.kill_worker(victim)
    assert names[0] in recovered
    assert co.owner_of(names[0]) != victim
    assert victim not in co.live_workers()
    for n, meta in recovered.items():
        offsets[n] = int(meta["offset"])

    for n in names:
        _feed(co, n, g, chunk=100, start=offsets[n])
        co.flush(n)
    expect = _reference(g)
    for n in names:
        worker = co.workers[co.owner_of(n)]
        assert _counts(worker.service.manager.get(n)) == expect, n
    assert co.stats()["failovers"] == len(recovered)


def test_cold_restart_from_store_is_byte_identical(tmp_path):
    g = random_graph(17, 500, 12, 2_000)
    co = _coordinator(2, checkpoint_dir=str(tmp_path), ingest_batch=96)
    for n in ("a", "b"):
        co.create_tenant(n)
        off = _feed(co, n, g, chunk=90, end=270)
        co.checkpoint(n, {"offset": off})

    co2 = _coordinator(2, checkpoint_dir=str(tmp_path), ingest_batch=96)
    recovered = co2.restore_all()
    assert sorted(recovered) == ["a", "b"]
    expect = _reference(g)
    for n, meta in recovered.items():
        _feed(co2, n, g, chunk=90, start=int(meta["offset"]))
        co2.flush(n)
        worker = co2.workers[co2.owner_of(n)]
        assert _counts(worker.service.manager.get(n)) == expect, n


def test_queries_route_to_owner_across_failover(tmp_path):
    g = random_graph(19, 300, 10, 1_200)
    co = _coordinator(2, checkpoint_dir=str(tmp_path), ingest_batch=64)
    co.create_tenant("t")
    _feed(co, "t", g, chunk=64, end=192)
    co.checkpoint("t", {"offset": 192})
    before = co.query(QueryRequest(session="t", op="total")).payload

    recovered = co.kill_worker(co.owner_of("t"))
    _feed(co, "t", g, chunk=64, start=int(recovered["t"]["offset"]),
          end=192)
    after = co.query(QueryRequest(session="t", op="total")).payload
    assert after == before


def test_dead_worker_rejects_calls_and_lost_tenant_without_checkpoint():
    co = _coordinator(2, ingest_batch=64, store=None)
    co.create_tenant("t")
    owner = co.owner_of("t")
    with pytest.raises(CheckpointError, match="no checkpoint store"):
        co.checkpoint("t")
    recovered = co.kill_worker(owner)
    assert recovered == {"t": None}
    assert co.stats()["tenants_lost"] == 1
    with pytest.raises(KeyError):
        co.owner_of("t")
    with pytest.raises(WorkerDown):
        co.workers[owner].tenants()
    with pytest.raises(WorkerDown):
        co.kill_worker(owner)


def test_comine_groups_by_owner_and_matches_independent():
    g = random_graph(23, 400, 10, 1_500)
    co = _coordinator(2, ingest_batch=64)
    co.create_tenant("a")
    co.create_tenant("b", delta=DELTA // 2)
    results = co.comine(g)
    assert sorted(results) == ["a", "b"]
    for name, cfg in (("a", _jax_cfg()), ("b", _jax_cfg(delta=DELTA // 2))):
        assert results[name].counts == JaxEngine(cfg).discover(g).counts, \
            name


def test_worker_sharded_mine_is_discover_or_sharded_on_a_mesh(tmp_path):
    """Without a mesh a worker's batch mine is ``engine.discover``; with
    one it is ``engine.sharded`` over the mesh, with the same counts as
    the JAX package's ``discover`` (``tests/test_cluster.py``'s mesh
    case)."""
    g = random_graph(29, 300, 9, 1_200)
    want = JaxEngine(_jax_cfg(zone_chunk=2)).discover(g).counts
    co = _coordinator(1, config=_cfg(zone_chunk=2), ingest_batch=64)
    plain = co.workers["w0"].sharded_mine(g)
    assert plain.counts == want
    with gloo_mesh(tmp_path) as mesh:
        meshed = _coordinator(1, config=_cfg(zone_chunk=2), mesh=mesh,
                              mesh_axes=("z",), ingest_batch=64)
        worker = meshed.workers["w0"]
        sharded = worker.sharded_mine(g)
        assert worker.engine.stats.sharded_calls == 1
    assert sharded.counts == want


def test_cluster_devices(monkeypatch):
    """Every worker's engine runs on the coordinator's device; without
    one and without CUDA, construction raises."""
    co = _coordinator(2)
    assert {str(w.engine.device) for w in co.workers.values()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterCoordinator(2, config=_cfg())


# ---------------------------------------------------------------------------
# The kill/restart harness through the port's CLI.
# ---------------------------------------------------------------------------


def test_harness_kill_and_restart_counts_equal(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ckdir = str(tmp_path / "ck")
    out = str(tmp_path / "report.json")
    base = [
        sys.executable, "-m", "repro_torch.launch.serve_motifs",
        "--device", "cpu", "--backend", "cuda",
        "--dataset", "collegemsg-like", "--delta", "60", "--l-max", "3",
        "--tenants", "2", "--workers", "2",
        "--chunk-edges", "1024", "--ingest-batch", "2048",
        "--queries-per-chunk", "0", "--checkpoint-dir", ckdir,
        "--checkpoint-every", "2048",
    ]
    killed = subprocess.run(base + ["--kill-after", "6000"], env=env,
                            capture_output=True, text=True, timeout=300,
                            cwd=ROOT)
    assert killed.returncode == 73, killed.stderr[-2000:]

    restarted = subprocess.run(base + ["--restart", "--out-json", out],
                               env=env, capture_output=True, text=True,
                               timeout=300, cwd=ROOT)
    assert restarted.returncode == 0, (restarted.stdout[-2000:],
                                       restarted.stderr[-2000:])
    report = json.load(open(out))
    assert report["mode"] == "restart"
    assert report["counts_equal"] is True
    assert report["query_p50_ms"] >= 0 and report["query_p99_ms"] >= 0
