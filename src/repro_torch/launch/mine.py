"""Mining CLI: PTMT motif-transition discovery end to end, on PyTorch.

``python -m repro_torch.launch.mine --backend cuda --dataset collegemsg-like``

Runs TZP partitioning + parallel expansion + signed aggregation through one
:class:`repro_torch.core.engine.PTMTEngine`, prints the transition tree,
and can cross-check against the sequential TMC-analog baseline.

The mining parameter surface (``--delta/--l-max/--omega/--e-cap/--backend/
...``) is declared by :meth:`repro_torch.core.config.MiningConfig.
add_cli_args` and parsed back into the validated config the engine is
built from.  ``--device`` (default ``cuda``) picks where the run's tensors
live.

``--check-sequential`` runs the sequential baseline on the same engine,
so on its own backend (``cuda``: one launch of the dense kernel over the
whole stream).

``--stream --chunk-edges N`` replays the dataset as an incremental stream
through ``engine.stream()`` (per-chunk latency + sustained edges/sec);
combine with ``--check-sequential`` to verify the final snapshot against
the sequential baseline.

Batch and stream runs emit the same end-of-run summary, and ``--out-json
FILE`` writes it with one schema for both modes: the JAX package's keys
(stream-only frontier stats under ``stream``, ``null`` for batch runs)
plus ``device``.
"""

from __future__ import annotations

import argparse
import json
import time

import repro_torch.obs as obs_mod
from repro_torch.core import MiningConfig, PTMTEngine
from repro_torch.core.streaming import replay_stream
from repro_torch.data import synthetic_graphs
from repro_torch.obs.timing import latency_summary


def _print_result(res, dt: float, label: str) -> None:
    print(f"{label}: {res.n_zones} zones (cap {res.e_cap}), "
          f"{len(res.counts)} motif types, "
          f"{res.total_processes()} processes in {dt:.2f}s")
    if res.layout:
        buckets = ", ".join(f"{b['label']}×{b['real_zones']}"
                            for b in res.layout["buckets"])
        print(f"zone layout: {res.layout['kind']} [{buckets}], "
              f"padding_ratio={res.layout['padding_ratio']:.1%}")
    print("level histogram:", dict(sorted(res.level_histogram().items())))
    print("\ntransition tree (top levels):")
    tree = res.tree()
    rows = tree.root.transition_rows()
    for code, count, share in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  {code}: {count} ({share:.1%})")
        node = tree.node(code)
        for ccode, ccount, cshare in sorted(
                node.transition_rows(), key=lambda r: -r[1])[:4]:
            print(f"    -> {ccode}: {ccount} ({cshare:.1%})")


def _summary(args, config: MiningConfig, graph, res, dt: float, mode: str,
             stream_stats: dict | None) -> dict:
    """One schema for batch and stream runs (``stream`` is null for batch)."""
    return {
        "mode": mode,
        "dataset": args.dataset,
        "seed": args.seed,
        "device": args.device,
        **config.to_dict(),
        "n_edges": graph.n_edges,
        "n_nodes": graph.n_nodes,
        "seconds": dt,
        "edges_per_s": graph.n_edges / dt if dt else 0.0,
        "n_zones": res.n_zones,
        "zone_e_cap": res.e_cap,
        "layout": res.layout,
        "overflow": res.overflow,
        "motif_types": len(res.counts),
        "total_processes": res.total_processes(),
        "level_histogram": {
            str(k): v for k, v in sorted(res.level_histogram().items())
        },
        "counts": res.counts,
        "stream": stream_stats,
    }


def _run_stream(args, engine: PTMTEngine, graph):
    if args.chunk_edges < 1:
        raise SystemExit("--chunk-edges must be >= 1")
    miner = engine.stream()
    chunk = args.chunk_edges
    latencies, dt = replay_stream(miner, graph, chunk)
    res = miner.snapshot(final=True)
    digest = latency_summary(latencies)
    stream_stats = {
        "chunk_edges": chunk,
        "chunks": digest["count"],
        "mean_chunk_ms": digest["mean_ms"],
        "max_chunk_ms": digest["max_ms"],
        "p50_chunk_ms": digest["p50_ms"],
        "p99_chunk_ms": digest["p99_ms"],
        "zones_finalized": miner.n_zones_finalized,
        "edges_retired": miner.n_edges_retired,
        "buffered_edges": miner.buffered_edges,
        "epoch": miner.epoch,
    }
    if latencies:
        print(f"stream: {len(latencies)} chunks of {chunk} edges, "
              f"{graph.n_edges / dt:.0f} edges/s sustained, "
              f"per-chunk latency "
              f"mean {stream_stats['mean_chunk_ms']:.1f}ms "
              f"max {stream_stats['max_chunk_ms']:.1f}ms")
    print(f"frontier: {miner.n_zones_finalized} zones finalized, "
          f"{miner.n_edges_retired} edges retired, "
          f"{miner.buffered_edges} still buffered")
    _print_result(res, dt, "PTMT-stream")
    return res, dt, stream_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    MiningConfig.add_cli_args(ap)
    ap.add_argument("--dataset", default="wikitalk-like",
                    choices=sorted(synthetic_graphs.DATASET_ANALOGS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    ap.add_argument("--stream", action="store_true",
                    help="replay the dataset incrementally through "
                         "engine.stream()")
    ap.add_argument("--chunk-edges", type=int, default=4096,
                    help="edges per ingested chunk in --stream mode")
    ap.add_argument("--check-sequential", action="store_true")
    ap.add_argument("--tree-depth", type=int, default=2)
    ap.add_argument("--out-json", default=None,
                    help="write the full run summary (same schema for "
                         "batch and stream modes)")
    obs_mod.add_cli_args(ap)
    args = ap.parse_args(argv)

    config = MiningConfig.from_cli_args(args)
    obs = obs_mod.from_cli_args(args)
    engine = PTMTEngine(config, device=args.device, obs=obs)
    graph = synthetic_graphs.make(args.dataset, seed=args.seed)
    print(f"{args.dataset}: {graph.n_edges} edges, {graph.n_nodes} nodes, "
          f"span {graph.time_span}s, device {engine.device}")

    if args.stream:
        res, dt, stream_stats = _run_stream(args, engine, graph)
        mode = "stream"
    else:
        t0 = time.perf_counter()
        res = engine.discover(graph)
        dt = time.perf_counter() - t0
        stream_stats = None
        mode = "batch"
        _print_result(res, dt, "PTMT")

    if args.check_sequential:
        t0 = time.perf_counter()
        seq = engine.sequential(graph)
        dt_seq = time.perf_counter() - t0
        match = seq.counts == res.counts
        print(f"\nsequential TMC-analog (backend {engine.backend!r}): "
              f"{dt_seq:.2f}s, exact match: {match}")
        if not match:
            raise SystemExit("MISMATCH between PTMT and sequential baseline")

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(_summary(args, config, graph, res, dt, mode,
                               stream_stats),
                      f, indent=1, sort_keys=True)
        print(f"summary written to {args.out_json}")

    obs_mod.write_cli_outputs(obs, args)


if __name__ == "__main__":
    main()
