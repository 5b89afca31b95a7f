"""Serving driver: replay a temporal graph into N tenant sessions under a
mixed query workload — single-service or multi-worker cluster mode.

``python -m repro_torch.launch.serve_motifs --tenants 4 --dataset sms-a-like``

The dataset's edge stream is strided into ``--tenants`` time-ordered tenant
streams, replayed round-robin in ``--chunk-edges`` arrival chunks, and
after every chunk each tenant receives ``--queries-per-chunk`` queries
drawn from a fixed mix (top-k, transition probabilities, prefix counts,
level histogram).  Without ``--workers`` all tenants are served by one
:class:`repro_torch.serving.motif.MotifService` over ONE shared
:class:`repro_torch.core.engine.PTMTEngine` (one resolved backend on one
device — the deployment shape).  ``--device`` (default ``cuda``) picks
that device; without CUDA the default raises.  The report is the serving SLO
view: sustained ingest edges/sec, query p50/p99 latency per op, and
snapshot-cache effectiveness.  ``--verify`` cross-checks every tenant's
final engine against batch discovery on its closed prefix (exact by
Lemma 4.2); ``--out-json`` writes the full report for tooling.

Cluster mode (``--workers N``) routes the same replay through a
:class:`repro_torch.serving.cluster.ClusterCoordinator` — tenants sharded
over N
workers by rendezvous hashing, per-tenant/global admission budgets whose
throttle signal the replay honors (drain, then retry the chunk), and
periodic per-tenant checkpoints carrying the stream offset in their
``meta``.  Fault injection::

    # healthy baseline
    ... --workers 2 --checkpoint-dir ck
    # die abruptly mid-ingest after ~50k edges (exit code 73, no cleanup
    # — everything since the last periodic checkpoint is lost, exactly
    # like kill -9)
    ... --workers 2 --checkpoint-dir ck --kill-after 50000
    # restart: restore every tenant from its checkpoint, rewind each feed
    # to the checkpointed offset, finish the stream, and assert final
    # counts are byte-identical to an uninterrupted run
    ... --workers 2 --checkpoint-dir ck --restart

``--bench-json PATH`` merges the run's SLO report into PATH (and only
there) under ``suites.serving_harness.runs.<mode>``, so healthy and
failure/restart numbers live side by side.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

import repro_torch.obs as obs_mod
from repro_torch.core import MiningConfig, PTMTEngine
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.data import synthetic_graphs
from repro_torch.obs.timing import percentile_ms
from repro_torch.serving.motif import MotifService, QueryRequest

#: Exit code of a ``--kill-after`` abrupt death (distinguishes the
#: injected kill from a real crash).
KILL_EXIT_CODE = 73

#: (op, kwargs-builder) workload mix — weights sum to 1.
QUERY_MIX = (
    (0.40, "top_k"),
    (0.25, "transition_probs"),
    (0.20, "prefix_count"),
    (0.15, "level_histogram"),
)


def tenant_streams(graph: TemporalGraph, tenants: int) -> list[TemporalGraph]:
    """Stride the stream into per-tenant streams (each stays time-ordered)."""
    return [
        TemporalGraph(u=graph.u[i::tenants], v=graph.v[i::tenants],
                      t=graph.t[i::tenants], n_nodes=graph.n_nodes)
        for i in range(tenants)
    ]


def sample_request(rng: np.random.Generator, session: str,
                   known_codes: list[str]) -> QueryRequest:
    r = float(rng.random())
    acc = 0.0
    op = QUERY_MIX[-1][1]
    for weight, name in QUERY_MIX:
        acc += weight
        if r < acc:
            op = name
            break
    code = ""
    if op in ("transition_probs", "prefix_count") and known_codes:
        code = known_codes[int(rng.integers(len(known_codes)))]
    level = int(rng.integers(1, 4)) if op == "top_k" else None
    return QueryRequest(session=session, op=op, code=code, level=level, k=8)


def run_workload(
    service: MotifService,
    streams: list[TemporalGraph],
    names: list[str],
    *,
    chunk_edges: int,
    queries_per_chunk: int,
    seed: int = 0,
):
    """Round-robin replay + query mix.

    Returns ``(ingest_lat, query_lat_by_op, first_call_lat_by_op)`` —
    first calls of a (tenant, op) pair pay one-time kernel-build and
    index-build cost (``QueryResponse.first_call``), so they are kept out
    of the steady-state ``query_lat`` series and reported separately.
    """
    rng = np.random.default_rng(seed)
    ingest_lat: list[float] = []
    query_lat: dict[str, list[float]] = {name: [] for _, name in QUERY_MIX}
    first_call_lat: dict[str, list[float]] = {
        name: [] for _, name in QUERY_MIX}
    known: dict[str, list[str]] = {n: [] for n in names}
    offsets = [0] * len(streams)
    live = True
    while live:
        live = False
        for name, g, idx in zip(names, streams, range(len(streams))):
            i = offsets[idx]
            if i >= g.n_edges:
                continue
            live = True
            offsets[idx] = i + chunk_edges
            t0 = time.perf_counter()
            service.ingest(name, g.u[i:i + chunk_edges],
                           g.v[i:i + chunk_edges], g.t[i:i + chunk_edges])
            ingest_lat.append(time.perf_counter() - t0)
            for _ in range(queries_per_chunk):
                req = sample_request(rng, name, known[name])
                resp = service.query(req)
                if resp.first_call:
                    first_call_lat[req.op].append(resp.latency_s)
                else:
                    query_lat[req.op].append(resp.latency_s)
                if req.op == "top_k" and resp.payload:
                    known[name] = [c for c, _ in resp.payload][:8]
    return ingest_lat, query_lat, first_call_lat


def build_report(service, names, n_edges, wall, ingest_lat, query_lat,
                 first_call_lat=None):
    all_q = [x for lats in query_lat.values() for x in lats]
    all_first = [x for lats in (first_call_lat or {}).values() for x in lats]
    stats = service.stats()
    lookups = stats["cache_hits"] + stats["cache_misses"]
    return {
        "tenants": len(names),
        "edges": n_edges,
        "seconds": wall,
        "ingest_edges_per_s": n_edges / wall if wall else 0.0,
        "ingest_chunks": len(ingest_lat),
        "ingest_p50_ms": percentile_ms(ingest_lat, 50),
        "ingest_p99_ms": percentile_ms(ingest_lat, 99),
        # steady-state only: first calls (kernel build + index build) are
        # reported under first_call_* so p50/p99 describe the warm service
        "queries": len(all_q),
        "query_p50_ms": percentile_ms(all_q, 50),
        "query_p99_ms": percentile_ms(all_q, 99),
        "first_calls": len(all_first),
        "first_call_max_ms": (1e3 * max(all_first)) if all_first else 0.0,
        "per_op": {
            op: {
                "count": len(lats),
                "p50_ms": percentile_ms(lats, 50),
                "p99_ms": percentile_ms(lats, 99),
            }
            for op, lats in sorted(query_lat.items())
        },
        "snapshots_mined": stats["snapshots_mined"],
        "cache_hit_rate": stats["cache_hits"] / lookups if lookups else 0.0,
        "sessions": stats["sessions"],
    }


def verify_against_batch(service, names, streams, *, delta, l_max, omega,
                         e_cap=None, backend="ref",
                         device=None) -> list[dict]:
    """Per-tenant cross-check of served counts against batch discovery on
    the closed prefix — the serving-layer restatement of the Lemma 4.2 test.

    Returns one row per tenant.  A row with ``batch_overflow > 0`` means the
    batch *reference* overflowed zone capacity and undercounts (the stream
    side is the exact one — see ``core/streaming.py``); strict equality is
    only meaningful when ``batch_overflow == 0``, so ``match`` is ``None``
    for those rows and callers must not fail on them.
    """
    ref_engine = PTMTEngine(MiningConfig(
        delta=delta, l_max=l_max, omega=omega, e_cap=e_cap,
        backend=backend, allow_overflow=True,
    ), device=device)
    rows = []
    for name, g in zip(names, streams):
        service.flush(name)
        sess = service.manager.get(name)
        engine = sess.engine()
        closed = sess.closed_time
        cut = 0 if closed is None else int(
            np.searchsorted(g.t, closed, side="left"))
        if cut == 0:
            rows.append({"tenant": name, "prefix_edges": 0,
                         "motif_types": 0, "batch_overflow": 0,
                         "match": engine.result.counts == {}})
            continue
        prefix = TemporalGraph(u=g.u[:cut], v=g.v[:cut], t=g.t[:cut],
                               n_nodes=g.n_nodes)
        expect = ref_engine.discover(prefix)
        rows.append({
            "tenant": name,
            "prefix_edges": prefix.n_edges,
            "motif_types": len(expect.counts),
            "batch_overflow": expect.overflow,
            "match": (engine.result.counts == expect.counts
                      if expect.overflow == 0 else None),
        })
    return rows


# -- cluster mode ------------------------------------------------------------


def run_cluster_workload(
    coordinator,
    streams: list[TemporalGraph],
    names: list[str],
    *,
    chunk_edges: int,
    queries_per_chunk: int,
    seed: int = 0,
    offsets: dict[str, int] | None = None,
    checkpoint_every: int = 0,
    kill_after: int | None = None,
):
    """Round-robin cluster replay honoring backpressure + fault injection.

    Per tenant the feed starts at ``offsets[name]`` (a restart resumes
    from the checkpointed offset).  A throttled ingest is **deferred, not
    dropped**: the chunk is retried after draining the tenant's admission
    window, so backpressure costs latency, never edges.  Every
    ``checkpoint_every`` fed edges a tenant is checkpointed with its
    post-chunk offset in the ``meta`` — the durable point a restart
    rewinds to.  ``kill_after`` N fed edges the process dies abruptly
    (``os._exit``, no flush, no final checkpoint, exit
    :data:`KILL_EXIT_CODE`) — the closest in-process stand-in for
    ``kill -9`` mid-ingest.
    """
    rng = np.random.default_rng(seed)
    ingest_lat: list[float] = []
    query_lat: dict[str, list[float]] = {name: [] for _, name in QUERY_MIX}
    first_call_lat: dict[str, list[float]] = {
        name: [] for _, name in QUERY_MIX}
    known: dict[str, list[str]] = {n: [] for n in names}
    pos = {n: int((offsets or {}).get(n, 0)) for n in names}
    since_ckpt = {n: 0 for n in names}
    throttle_events = 0
    checkpoints_written = 0
    total_fed = 0
    live = True
    while live:
        live = False
        for name, g in zip(names, streams):
            i = pos[name]
            if i >= g.n_edges:
                continue
            live = True
            u = g.u[i:i + chunk_edges]
            v = g.v[i:i + chunk_edges]
            t = g.t[i:i + chunk_edges]
            t0 = time.perf_counter()
            while True:
                ack = coordinator.ingest(name, u, v, t)
                if not ack.throttled:
                    break
                # budget bound: drain this tenant's window, then retry —
                # the replay honors the throttle instead of buffering past
                # the budget (deferred, never dropped)
                throttle_events += 1
                coordinator.flush(name)
            ingest_lat.append(time.perf_counter() - t0)
            pos[name] = i + int(np.asarray(t).size)
            total_fed += int(np.asarray(t).size)
            since_ckpt[name] += int(np.asarray(t).size)
            if kill_after is not None and total_fed >= kill_after:
                # abrupt death mid-ingest: skip flushes, skip the final
                # checkpoint — state since the last periodic checkpoint
                # is lost, exactly the kill -9 contract
                os._exit(KILL_EXIT_CODE)
            if checkpoint_every and since_ckpt[name] >= checkpoint_every:
                coordinator.checkpoint(name, {"offset": pos[name]})
                checkpoints_written += 1
                since_ckpt[name] = 0
            for _ in range(queries_per_chunk):
                req = sample_request(rng, name, known[name])
                resp = coordinator.query(req)
                if resp.first_call:
                    first_call_lat[req.op].append(resp.latency_s)
                else:
                    query_lat[req.op].append(resp.latency_s)
                if req.op == "top_k" and resp.payload:
                    known[name] = [c for c, _ in resp.payload][:8]
    return {
        "ingest_lat": ingest_lat,
        "query_lat": query_lat,
        "first_call_lat": first_call_lat,
        "offsets": pos,
        "throttle_events": throttle_events,
        "checkpoints_written": checkpoints_written,
        "edges_fed": total_fed,
    }


def tenant_counts(coordinator, name: str) -> dict:
    """A tenant's full served count table (closed prefix + open tail)."""
    worker = coordinator.workers[coordinator.owner_of(name)]
    return worker.service.manager.get(name).engine().result.counts


def reference_counts(config, streams, names, *, ingest_batch,
                     device=None) -> dict:
    """Uninterrupted single-process replay — the byte-identity baseline."""
    service = MotifService(engine=PTMTEngine(config, device=device),
                           ingest_batch=ingest_batch)
    out = {}
    for name, g in zip(names, streams):
        service.create_session(name)
        service.ingest(name, g.u, g.v, g.t)
        service.flush(name)
        out[name] = service.manager.get(name).engine().result.counts
    return out


def build_cluster_report(coordinator, names, run, n_edges, wall, *,
                         mode: str) -> dict:
    all_q = [x for lats in run["query_lat"].values() for x in lats]
    all_first = [x for lats in run["first_call_lat"].values() for x in lats]
    stats = coordinator.stats()
    services = [w["service"] for w in stats["workers"].values()
                if w["service"] is not None]
    hits = sum(s["cache_hits"] for s in services)
    lookups = hits + sum(s["cache_misses"] for s in services)
    deferred = sum(w["admission"]["deferred_edges"]
                   for w in stats["workers"].values())
    shed = sum(w["admission"]["shed_edges"]
               for w in stats["workers"].values())
    return {
        "mode": mode,
        "workers": stats["n_workers"],
        "live_workers": stats["live_workers"],
        "placement": stats["placement"],
        "tenants": len(names),
        "edges_fed": run["edges_fed"],
        "edges_total": n_edges,
        "seconds": wall,
        "ingest_edges_per_s": run["edges_fed"] / wall if wall else 0.0,
        "ingest_p50_ms": percentile_ms(run["ingest_lat"], 50),
        "ingest_p99_ms": percentile_ms(run["ingest_lat"], 99),
        "queries": len(all_q),
        "query_p50_ms": percentile_ms(all_q, 50),
        "query_p99_ms": percentile_ms(all_q, 99),
        "first_calls": len(all_first),
        "throttle_events": run["throttle_events"],
        "deferred_edges": deferred,
        "shed_edges": shed,
        "checkpoints_written": run["checkpoints_written"],
        "failovers": stats["failovers"],
        "snapshots_mined": sum(s["snapshots_mined"] for s in services),
        "cache_hit_rate": hits / lookups if lookups else 0.0,
    }


def merge_bench_json(path: str, mode: str, report: dict) -> None:
    """Land ``report`` under ``suites.serving_harness.runs[mode]``.

    The document has a top-level ``suites`` keyed by suite name, as the
    JAX package's benchmark output does.
    """
    doc = {"suites": {}}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
        doc.setdefault("suites", {})
    suite = doc["suites"].setdefault(
        "serving_harness", {"suite": "serving_harness", "runs": {}})
    suite.setdefault("runs", {})[mode] = report
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def run_cluster_mode(args, config, obs, graph, streams, names) -> dict:
    from repro_torch.serving.cluster import ClusterCoordinator

    if not args.checkpoint_dir and (args.restart or args.kill_after):
        raise SystemExit("--kill-after/--restart require --checkpoint-dir")
    coordinator = ClusterCoordinator(
        args.workers, config=config, checkpoint_dir=args.checkpoint_dir,
        tenant_budget=args.tenant_budget, global_budget=args.global_budget,
        ingest_batch=args.ingest_batch, device=args.device, obs=obs)
    mode = "restart" if args.restart else (
        "killed" if args.kill_after else "healthy")
    offsets: dict[str, int] = {}
    if args.restart:
        recovered = coordinator.restore_all()
        missing = sorted(set(names) - set(recovered))
        if missing:
            raise SystemExit(
                f"--restart found no checkpoint for tenants {missing} "
                f"under {args.checkpoint_dir}")
        offsets = {n: int(m.get("offset", 0)) for n, m in recovered.items()}
        print(f"restored {len(recovered)} tenants from "
              f"{args.checkpoint_dir}; resuming at offsets "
              f"{[offsets[n] for n in names]}")
    else:
        for name in names:
            coordinator.create_tenant(name)
            if args.checkpoint_dir:
                # durable from birth: a kill before the first periodic
                # checkpoint restarts the tenant from offset 0, never
                # loses the tenant itself
                coordinator.checkpoint(name, {"offset": 0})
    print(f"cluster: {args.workers} workers, placement "
          f"{coordinator.placement()}")

    t0 = time.perf_counter()
    run = run_cluster_workload(
        coordinator, streams, names, chunk_edges=args.chunk_edges,
        queries_per_chunk=args.queries_per_chunk, seed=args.seed,
        offsets=offsets,
        checkpoint_every=(args.checkpoint_every if args.checkpoint_dir
                          else 0),
        kill_after=args.kill_after,
    )
    coordinator.flush_all()
    wall = time.perf_counter() - t0
    if args.checkpoint_dir:
        coordinator.checkpoint_all(
            {n: {"offset": run["offsets"][n]} for n in names})
    report = build_cluster_report(coordinator, names, run, graph.n_edges,
                                  wall, mode=mode)

    print(f"ingest: {report['ingest_edges_per_s']:.0f} edges/s sustained, "
          f"chunk p50 {report['ingest_p50_ms']:.1f}ms "
          f"p99 {report['ingest_p99_ms']:.1f}ms, "
          f"{report['throttle_events']} throttle events "
          f"({report['deferred_edges']} edges deferred)")
    print(f"query: {report['queries']} served steady-state, "
          f"p50 {report['query_p50_ms']:.2f}ms "
          f"p99 {report['query_p99_ms']:.2f}ms, "
          f"cache hit rate {report['cache_hit_rate']:.1%}; "
          f"{report['checkpoints_written']} checkpoints written")

    if args.restart or args.verify:
        ref = reference_counts(config, streams, names,
                               ingest_batch=args.ingest_batch,
                               device=args.device)
        equal = all(tenant_counts(coordinator, n) == ref[n] for n in names)
        report["counts_equal"] = equal
        print(f"counts_equal={'true' if equal else 'FALSE'} vs "
              f"uninterrupted replay"
              + (" after restart-from-checkpoint" if args.restart else ""))
        if not equal:
            raise SystemExit(
                "restored counts diverged from uninterrupted run")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    MiningConfig.add_cli_args(ap)
    ap.add_argument("--dataset", default="sms-a-like",
                    choices=sorted(synthetic_graphs.DATASET_ANALOGS))
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--chunk-edges", type=int, default=2048,
                    help="edges per tenant arrival chunk")
    ap.add_argument("--ingest-batch", type=int, default=8192,
                    help="admission buffer flush threshold per session")
    ap.add_argument("--queries-per-chunk", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda or cpu)")
    ap.add_argument("--verify", action="store_true",
                    help="cross-check every tenant against batch discover")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--workers", type=int, default=0,
                    help="cluster mode: shard tenants over N workers "
                         "(0 = single shared service)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="cluster mode: per-tenant checkpoint directory")
    ap.add_argument("--checkpoint-every", type=int, default=4096,
                    help="edges fed per tenant between periodic checkpoints")
    ap.add_argument("--kill-after", type=int, default=None, metavar="EDGES",
                    help=f"die abruptly (os._exit {KILL_EXIT_CODE}, no "
                         f"cleanup) after feeding EDGES edges — kill -9 "
                         f"fault injection")
    ap.add_argument("--restart", action="store_true",
                    help="restore tenants from --checkpoint-dir, rewind "
                         "feeds to checkpointed offsets, finish the "
                         "stream, and verify counts byte-identical to an "
                         "uninterrupted run")
    ap.add_argument("--tenant-budget", type=int, default=65536,
                    help="cluster mode: per-tenant pending-edge budget")
    ap.add_argument("--global-budget", type=int, default=None,
                    help="cluster mode: per-worker global pending budget")
    ap.add_argument("--bench-json", default=None, metavar="PATH",
                    help="merge this run's SLO report into PATH under "
                         "suites.serving_harness.runs.<mode>")
    obs_mod.add_cli_args(ap)
    args = ap.parse_args(argv)
    if args.tenants < 1:
        raise SystemExit("--tenants must be >= 1")

    config = MiningConfig.from_cli_args(args)
    obs = obs_mod.from_cli_args(args)
    graph = synthetic_graphs.make(args.dataset, seed=args.seed)
    streams = tenant_streams(graph, args.tenants)
    names = [f"tenant{i}" for i in range(args.tenants)]

    if args.workers > 0:
        report = run_cluster_mode(args, config, obs, graph, streams, names)
        if args.out_json:
            with open(args.out_json, "w") as f:
                json.dump(report, f, indent=1, sort_keys=True)
            print(f"report written to {args.out_json}")
        if args.bench_json:
            merge_bench_json(args.bench_json, report["mode"], report)
            print(f"SLO report merged into {args.bench_json} "
                  f"(runs.{report['mode']})")
        obs_mod.write_cli_outputs(obs, args)
        return
    if args.restart or args.kill_after or args.checkpoint_dir:
        raise SystemExit(
            "--checkpoint-dir/--kill-after/--restart need cluster mode "
            "(--workers N)")

    engine = PTMTEngine(config, device=args.device, obs=obs)
    service = MotifService(engine=engine, ingest_batch=args.ingest_batch,
                           obs=obs)
    for name in names:
        service.create_session(name)
    print(f"{args.dataset}: {graph.n_edges} edges over {args.tenants} "
          f"tenants, chunk {args.chunk_edges}, "
          f"admission batch {args.ingest_batch}")

    t0 = time.perf_counter()
    ingest_lat, query_lat, first_call_lat = run_workload(
        service, streams, names, chunk_edges=args.chunk_edges,
        queries_per_chunk=args.queries_per_chunk, seed=args.seed,
    )
    wall = time.perf_counter() - t0
    report = build_report(service, names, graph.n_edges, wall,
                          ingest_lat, query_lat, first_call_lat)

    print(f"ingest: {report['ingest_edges_per_s']:.0f} edges/s sustained, "
          f"chunk p50 {report['ingest_p50_ms']:.1f}ms "
          f"p99 {report['ingest_p99_ms']:.1f}ms")
    print(f"query: {report['queries']} served steady-state, "
          f"p50 {report['query_p50_ms']:.2f}ms "
          f"p99 {report['query_p99_ms']:.2f}ms, "
          f"cache hit rate {report['cache_hit_rate']:.1%} "
          f"({report['snapshots_mined']} snapshots mined); "
          f"{report['first_calls']} first calls excluded "
          f"(max {report['first_call_max_ms']:.1f}ms)")
    for op, row in report["per_op"].items():
        print(f"  {op}: n={row['count']} p50 {row['p50_ms']:.2f}ms "
              f"p99 {row['p99_ms']:.2f}ms")

    if args.verify:
        failed = False
        for row in verify_against_batch(
                service, names, streams, delta=args.delta,
                l_max=args.l_max, omega=args.omega, e_cap=args.e_cap,
                backend=args.backend, device=args.device):
            if row["match"] is None:
                print(f"verify {row['tenant']}: strict check skipped — "
                      f"batch reference overflowed "
                      f"{row['batch_overflow']} edges (the stream side "
                      f"is the exact one; rerun without --e-cap)")
                continue
            status = ("exact match" if row["match"] else "MISMATCH")
            print(f"verify {row['tenant']}: {status} on closed prefix "
                  f"({row['prefix_edges']} edges, "
                  f"{row['motif_types']} motif types)")
            failed = failed or not row["match"]
        if failed:
            raise SystemExit("served counts != batch discover")

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"report written to {args.out_json}")

    obs_mod.write_cli_outputs(obs, args)


if __name__ == "__main__":
    main()
