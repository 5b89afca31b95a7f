"""Quickstart: discover motif transition processes in a temporal graph.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a small synthetic interaction stream, runs PTMT (zone-partitioned
parallel discovery) through the session engine, validates against the
sequential TMC-analog baseline, and prints the motif transition tree
(paper Fig. 6).

The engine uses the ``cuda`` backend: ``discover`` takes the fused path,
one launch of the flat zone-scan kernel, and ``sequential`` one launch of
the dense kernel over the one-zone batch.  (The default ``ref`` backend is
plain torch and would launch no kernel.)  On the CPU the same backend runs
the kernels' plain versions; the counts are exact either way.  Runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from repro_torch.core import DiscoveryResult, MiningConfig, PTMTEngine
from repro_torch.data.synthetic_graphs import triadic_stream

_LABELS = {"010121": "triangle", "010102": "chain", "010101": "reciprocal"}


def main(device=None) -> DiscoveryResult:
    """Mine the quickstart stream, check it against the sequential
    baseline and print the layout and the tree; returns the result."""
    # a triadic-closure-heavy interaction stream (paper's WikiTalk case study)
    graph = triadic_stream(5_000, 150, window=240, p_close=0.5, seed=7)
    print(f"graph: {graph.n_edges} edges / {graph.n_nodes} nodes / "
          f"{graph.time_span}s span")

    # --- PTMT: one validated config, one engine owning the device state --
    config = MiningConfig(delta=120, l_max=4, omega=8, backend="cuda")
    engine = PTMTEngine(config, device=device)
    result = engine.discover(graph)
    print(f"\nPTMT: {result.n_zones} zones, {len(result.counts)} motif "
          f"types, {result.total_processes()} processes "
          f"(overflow={result.overflow})")

    # a second run on the same stream skips host-side planning via the
    # plan cache and sweeps the layout in one more kernel launch
    engine.discover(graph)
    print(f"engine reuse: {engine.stats.plan_cache_hits} zone-plan cache "
          f"hit(s), {engine.stats.launches} scan launch(es), "
          f"{engine.stats.fused_runs} fused run(s)")

    # --- zone-batch layout: how the device batch was actually shaped -----
    lay = result.layout
    print(f"zone layout: {lay['kind']}, {len(lay['buckets'])} bucket(s), "
          f"padding_ratio={lay['padding_ratio']:.1%}")
    for b in lay["buckets"]:
        print(f"  {b['label']}: {b['real_zones']} zones x cap {b['e_cap']} "
              f"({b['occupancy']:.1%} occupied)")

    # --- exactness: matches the unpartitioned sequential baseline --------
    seq = engine.sequential(graph)
    if seq.counts != result.counts:
        raise RuntimeError("partitioned counts must be exact!")
    print("exactness check vs sequential baseline: PASS")

    # --- the motif transition tree (paper Fig. 6 / Table 6) --------------
    tree = result.tree()
    print("\nmotif transition tree:")
    for code, count, share in sorted(tree.root.transition_rows(),
                                     key=lambda r: -r[1])[:4]:
        print(f"  {code}: {count} processes ({share:.1%})")
        for c2, n2, s2 in sorted(tree.node(code).transition_rows(),
                                 key=lambda r: -r[1])[:3]:
            print(f"    -> {c2}: {n2} ({s2:.1%}) {_LABELS.get(c2, '')}")

    hist = result.level_histogram()
    print("\nprocesses by final length:", dict(sorted(hist.items())))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: CUDA)")
    main(device=ap.parse_args().device)
