"""Temporal graph container used by the PTMT pipeline.

A temporal graph is a time-ordered stream of directed edges ``(u, v, t)``
(Definition 1 of the paper).  We keep it as three parallel arrays sorted by
``(t, arrival index)``.  Timestamps are normalized to ``int32`` offsets from
``t_min`` — every dataset in the paper spans < 2^31 seconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """Sorted temporal edge stream.

    Attributes:
      u: int32[n] source node ids (>= 0).
      v: int32[n] destination node ids (>= 0).
      t: int32[n] timestamps, non-decreasing, offset so ``t[0] >= 0``.
      n_nodes: number of distinct nodes (max id + 1).
    """

    u: np.ndarray
    v: np.ndarray
    t: np.ndarray
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.u.shape[0])

    @property
    def time_span(self) -> int:
        if self.n_edges == 0:
            return 0
        return int(self.t[-1] - self.t[0])

    def __post_init__(self):
        if not (self.u.shape == self.v.shape == self.t.shape):
            raise ValueError("u, v, t must have identical shapes")
        if self.t.size and np.any(np.diff(self.t) < 0):
            raise ValueError("timestamps must be non-decreasing")


def from_edges(u, v, t, *, stable: bool = True) -> TemporalGraph:
    """Build a :class:`TemporalGraph` from unsorted edge triples.

    Ties in ``t`` keep arrival order (stable sort) so that the discovery
    semantics are deterministic, matching the paper's stream model.
    """
    u = np.asarray(u)
    v = np.asarray(v)
    t = np.asarray(t)
    if u.ndim != 1:
        raise ValueError("edges must be 1-D arrays")
    if not (u.shape == v.shape == t.shape):
        raise ValueError("u, v, t must have identical shapes")
    order = np.argsort(t, kind="stable" if stable else "quicksort")
    u, v, t = u[order], v[order], t[order]
    if t.size:
        t = t - t.min()
    n_nodes = int(max(u.max(initial=-1), v.max(initial=-1)) + 1) if u.size else 0
    return TemporalGraph(
        u=u.astype(np.int32), v=v.astype(np.int32), t=t.astype(np.int32),
        n_nodes=n_nodes,
    )
