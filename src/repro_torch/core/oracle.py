"""Brute-force motif-transition-process oracle (host-side, pure Python).

Independent of every torch code path; used by tests and benchmarks as ground
truth for the paper's semantics (Definitions 2-4):

* each edge seeds one 1-edge process (processes never fork — Definition 3's
  "no earlier valid transition" rule makes the successor unique);
* a process with last edge at ``t_l`` absorbs the first later edge ``(u,v,t)``
  with ``t > t_l``, ``t - t_l <= delta`` and ``{u,v}`` intersecting its node
  set, until it has ``l_max`` edges or the window ``(t_l, t_l + delta]``
  passes with no eligible edge.

Complexity O(n^2 l_max) — fine for the <= few-thousand-edge graphs tests use.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from .encoding import decode_code_np, encode_process_np


def enumerate_processes(u, v, t, delta: int, l_max: int) -> list[list[int]]:
    """Return, per seed edge, the list of edge indices of its process."""
    u = np.asarray(u)
    v = np.asarray(v)
    t = np.asarray(t)
    n = len(u)
    processes = []
    for seed in range(n):
        edges = [seed]
        nodes = {int(u[seed]), int(v[seed])}
        last_t = int(t[seed])
        j = seed + 1
        while len(edges) < l_max:
            extended = False
            while j < n and int(t[j]) <= last_t + delta:
                tj = int(t[j])
                if tj > last_t and (int(u[j]) in nodes or int(v[j]) in nodes):
                    edges.append(j)
                    nodes.add(int(u[j]))
                    nodes.add(int(v[j]))
                    last_t = tj
                    extended = True
                    j += 1
                    break
                j += 1
            if not extended:
                break
        # NB: the inner cursor j only moves forward; restart scanning for the
        # *next* extension right after the edge just absorbed.
        processes.append(edges)
    return processes


def count_codes(u, v, t, delta: int, l_max: int) -> Counter:
    """Counter mapping paper-style code strings -> process counts."""
    counts: Counter = Counter()
    for edges in enumerate_processes(u, v, t, delta, l_max):
        code = encode_process_np(
            [(int(u[e]), int(v[e])) for e in edges], l_max
        )
        counts[decode_code_np(code)] += 1
    return counts


def transition_counts(final_counts: Counter) -> Counter:
    """Per-level transition statistics from final-code counts.

    A process stopping at code ``c`` passed through every even-length prefix
    of ``c``; the through-count of prefix ``p`` is the paper's transition
    count into ``p``.
    """
    through: Counter = Counter()
    for code, cnt in final_counts.items():
        for level in range(2, len(code) + 1, 2):
            through[code[:level]] += cnt
    return through
