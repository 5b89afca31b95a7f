"""One rank's block of zones, cut by a frozen copy of the program's TZP
planner and its dense batch rule.

Originals: ``src/repro_torch/core/tzp.py``: ``plan_zones`` (Algorithm 1:
growth zones of ``omega * l_b`` seconds, ``l_b = delta * l_max``, each
shrunk to its ``e_cap + 1``-th edge but never below ``2 l_b``, and the
``l_b``-second overlap of two growth zones as a boundary zone), with
``adaptive_zone_end``, and ``build_zone_batch`` with ``fill_zone_row``
(the dense layout: a ``[Z, e_cap]`` batch, zones ordered biggest first,
each zone's edges as a valid prefix of its row, the rest of the row
padded with the zone's last time; sign +1 for a growth zone and -1 for a
boundary zone).  That is the batch the engine builds for
``MiningConfig(e_cap=..., zone_layout="dense")`` on one rank.

What changed: the block is the plan's first ``n_zones`` zones (a stretch
of the stream that holds that many, the zones a rank given one time range
of a longer stream mines), not every zone of the stream, so that the
stream's unshrunk last growth zone is never in it; a zone that would not
fit its row raises instead of being cut; the graph comes as arrays.
"""

from __future__ import annotations

import numpy as np


def plan_zones(t, *, delta: int, l_max: int, omega: int, e_cap: int,
               n_zones: int):
    """The first ``n_zones`` zones of TZP's plan of the time-sorted
    stream ``t``: ``(lo, count, sign)`` int64 arrays."""
    t = np.asarray(t, np.int64)
    l_b = delta * l_max
    l_g = omega * l_b
    t_max = int(t[-1])
    lo_l, cnt_l, sign_l = [], [], []
    s = int(t[0])
    while len(lo_l) < n_zones:
        e = s + l_g
        lo = int(np.searchsorted(t, s, side="left"))
        if e > t_max:
            raise ValueError(
                f"the stream holds {len(lo_l)} whole zones, fewer than "
                f"the block's {n_zones}: give it more edges")
        if int(np.searchsorted(t, e, side="left")) - lo > e_cap:
            e = int(np.clip(int(t[lo + e_cap]), s + 2 * l_b, e))
        hi = int(np.searchsorted(t, e, side="left"))
        b_lo = int(np.searchsorted(t, e - l_b, side="left"))
        lo_l += [lo, b_lo]
        cnt_l += [hi - lo, hi - b_lo]
        sign_l += [1, -1]
        s = e - l_b
    return (np.asarray(lo_l[:n_zones], np.int64),
            np.asarray(cnt_l[:n_zones], np.int64),
            np.asarray(sign_l[:n_zones], np.int64))


def build(graph, *, seed=None, delta: int, l_max: int, omega: int,
          n_zones: int, e_cap: int):
    """Zone batch ``[n_zones, e_cap]`` of the plan's first ``n_zones``
    zones: ``(u, v, t, valid, signs)``, int32 ``[Z, E]`` arrays, a bool
    ``[Z, E]`` mask and int32 ``[Z]`` signs.  The plan has no randomness:
    ``seed`` is taken for a batch builder's common signature only."""
    u, v, t = (np.asarray(x) for x in graph[:3])
    lo, count, sign = plan_zones(t, delta=delta, l_max=l_max, omega=omega,
                                 e_cap=e_cap, n_zones=n_zones)
    if count.max() > e_cap:
        raise ValueError(f"a zone holds {int(count.max())} edges, more "
                         f"than its row's {e_cap}")
    order = np.argsort(-count, kind="stable")
    out = [np.zeros((n_zones, e_cap), np.int32) for _ in range(3)]
    valid = np.zeros((n_zones, e_cap), bool)
    signs = np.zeros(n_zones, np.int32)
    for row, z in enumerate(order):
        a, n = int(lo[z]), int(count[z])
        for dst, src in zip(out, (u, v, t)):
            dst[row, :n] = src[a:a + n]
        if n:
            out[2][row, n:] = t[a + n - 1]
        valid[row, :n] = True
        signs[row] = sign[z]
    return (*out, valid, signs)
