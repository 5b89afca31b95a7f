"""Synthetic temporal-graph generators standing in for the paper's datasets.

The 10 real datasets (Email-Eu ... Soc-bitcoin) are not available offline, so
benchmarks use generators that reproduce their salient statistics: power-law
degree, bursty inter-event times (the paper's "long-tailed event
distributions"), and controllable density relative to ``delta``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.temporal_graph import TemporalGraph, from_edges


def poisson_stream(
    n_edges: int, n_nodes: int, *, rate: float = 1.0, seed: int = 0
) -> TemporalGraph:
    """Uniform-random endpoints, exponential inter-arrival times."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n_edges)
    t = np.cumsum(gaps).astype(np.int64)
    u = rng.integers(0, n_nodes, n_edges)
    v = rng.integers(0, n_nodes, n_edges)
    return from_edges(u, v, t)


def powerlaw_stream(
    n_edges: int,
    n_nodes: int,
    *,
    alpha: float = 1.5,
    rate: float = 1.0,
    seed: int = 0,
) -> TemporalGraph:
    """Power-law node popularity (social-network-like hubs)."""
    rng = np.random.default_rng(seed)
    weights = (np.arange(1, n_nodes + 1, dtype=np.float64)) ** (-alpha)
    p = weights / weights.sum()
    u = rng.choice(n_nodes, n_edges, p=p)
    v = rng.choice(n_nodes, n_edges, p=p)
    gaps = rng.exponential(1.0 / rate, n_edges)
    t = np.cumsum(gaps).astype(np.int64)
    return from_edges(u, v, t)


def bursty_stream(
    n_edges: int,
    n_nodes: int,
    *,
    burst_size: int = 20,
    burst_span: int = 60,
    gap_span: int = 3600,
    seed: int = 0,
) -> TemporalGraph:
    """Bursts of correlated activity separated by quiet gaps.

    Reproduces the paper's "rapid burst chains" (Section 5.6) — groups of
    edges among few nodes inside a short window, then a long pause.  This is
    the regime where TZP's adaptive zoning matters (dense zones shrink).
    """
    rng = np.random.default_rng(seed)
    us, vs, ts = [], [], []
    t = 0
    remaining = n_edges
    while remaining > 0:
        k = min(int(rng.integers(1, burst_size + 1)), remaining)
        group = rng.integers(0, n_nodes, size=max(2, k // 3 + 2))
        for _ in range(k):
            a, b = rng.choice(group, 2, replace=True)
            us.append(a)
            vs.append(b)
            ts.append(t + int(rng.integers(0, burst_span)))
        t += gap_span + int(rng.integers(0, gap_span))
        remaining -= k
    return from_edges(np.array(us), np.array(vs), np.array(ts))


def triadic_stream(
    n_edges: int, n_nodes: int, *, window: int = 300, p_close: float = 0.4,
    seed: int = 0,
) -> TemporalGraph:
    """Triadic-closure-biased stream (WikiTalk-like transition profile).

    With probability ``p_close`` a new edge closes an open wedge from the
    recent window, yielding the triangle-heavy transition trees the paper's
    case study reports.
    """
    rng = np.random.default_rng(seed)
    us, vs, ts = [], [], []
    t = 0
    recent: list[tuple[int, int]] = []
    for _ in range(n_edges):
        t += int(rng.integers(1, window // 4 + 1))
        if recent and rng.random() < p_close and len(recent) >= 2:
            a, b = recent[int(rng.integers(0, len(recent)))]
            c = int(rng.integers(0, n_nodes))
            u, v = b, c
            if rng.random() < 0.5:
                u, v = (a, b) if rng.random() < 0.5 else (c, a)
        else:
            u = int(rng.integers(0, n_nodes))
            v = int(rng.integers(0, n_nodes))
        us.append(u)
        vs.append(v)
        ts.append(t)
        recent.append((u, v))
        if len(recent) > 64:
            recent.pop(0)
    return from_edges(np.array(us), np.array(vs), np.array(ts))


DATASET_ANALOGS = {
    # name -> (generator, kwargs) sized as CPU-scale analogs of Table 1
    "collegemsg-like": (poisson_stream, dict(n_edges=20_000, n_nodes=1_899)),
    "email-eu-like": (powerlaw_stream, dict(n_edges=33_000, n_nodes=986)),
    "sms-a-like": (bursty_stream, dict(n_edges=54_000, n_nodes=4_409)),
    "wikitalk-like": (triadic_stream, dict(n_edges=78_000, n_nodes=11_401)),
}


def make(name: str, seed: int = 0) -> TemporalGraph:
    gen, kwargs = DATASET_ANALOGS[name]
    return gen(seed=seed, **kwargs)
