"""Frozen copy of the port's ``powerlaw_stream`` generator.

Original: ``src/repro_torch/data/synthetic_graphs.py`` (``powerlaw_stream``,
with ``temporal_graph.from_edges`` for the sort and the time offset), the
generator behind the ``email-eu-like`` analog.  Copied so that a later
change to the program cannot change the benchmark's inputs.

What changed: it returns plain numpy arrays instead of a
``TemporalGraph`` (the benchmark builds the program's type itself), the
seed is a keyword with no default, and the draw is otherwise the same call
for call, so a seed gives the same edges as the original.
"""

from __future__ import annotations

import numpy as np


def generate(*, seed, n_edges: int, n_nodes: int, alpha: float = 1.5,
             rate: float = 1.0):
    """Power-law node popularity, exponential inter-arrival times.

    Returns ``(u, v, t, n_nodes)``: int32 arrays sorted by time (ties in
    arrival order), ``t`` offset so that its first value is 0, and the
    number of node ids (max id + 1).
    """
    rng = np.random.default_rng(seed)
    weights = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    p = weights / weights.sum()
    u = rng.choice(n_nodes, n_edges, p=p)
    v = rng.choice(n_nodes, n_edges, p=p)
    gaps = rng.exponential(1.0 / rate, n_edges)
    t = np.cumsum(gaps).astype(np.int64)
    order = np.argsort(t, kind="stable")
    u, v, t = u[order], v[order], t[order]
    if t.size:
        t = t - t.min()
    n_ids = int(max(u.max(initial=-1), v.max(initial=-1)) + 1) if u.size else 0
    return (u.astype(np.int32), v.astype(np.int32), t.astype(np.int32),
            n_ids)
