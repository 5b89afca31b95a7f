"""Shared inputs of the PyTorch port's tests (``test_torch_*.py``).

Graphs are built with numpy from a seed, so the JAX package and the port
see the same arrays.  ``powerlaw_bursty`` regenerates the power-law bursty
corpus of ``test_differential.py`` (``_powerlaw_bursty``): zone sizes span
several power-of-two buckets.
"""

import numpy as np

from repro.core.temporal_graph import from_edges


def powerlaw_bursty(seed, n=220, nodes=9):
    """Power-law burst sizes + quiet gaps: zone sizes span several
    power-of-two buckets (the skew regime the bucketed layout targets)."""
    rng = np.random.default_rng(seed)
    us, vs, ts = [], [], []
    now = 0
    while len(ts) < n:
        burst = min(int(rng.pareto(0.9) * 3) + 1, 70)
        group = rng.integers(0, nodes, size=max(2, burst // 4 + 2))
        for _ in range(burst):
            a, b = rng.choice(group, 2, replace=True)
            us.append(a)
            vs.append(b)
            ts.append(now + int(rng.integers(0, 30)))
        now += int(rng.integers(150, 700))
    return from_edges(np.asarray(us[:n]), np.asarray(vs[:n]),
                      np.asarray(ts[:n]))


#: (name, graph factory, (delta, l_max, omega)) — l_max=7 spills a code
#: into a second limb; nodes=3 makes self-loops u == v common
CASES = (
    ("bursty", lambda: powerlaw_bursty(5), (12, 3, 2)),
    ("bursty-l7", lambda: powerlaw_bursty(5), (30, 7, 2)),
    ("self-loops", lambda: powerlaw_bursty(11, nodes=3), (40, 5, 2)),
    ("l1", lambda: powerlaw_bursty(3), (20, 1, 2)),
)
CASE_IDS = [c[0] for c in CASES]


def to_torch(*arrays):
    import torch

    return [torch.as_tensor(np.asarray(a)) for a in arrays]
