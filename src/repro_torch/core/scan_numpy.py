"""Pure-NumPy zone-scan backend (oracle-grade, host-side).

Same semantics as :func:`repro_torch.core.expansion.scan_zones` —
candidate *i* is the process seeded by edge slot *i*, extended by
Definition 3's unique-successor rule — but implemented as the brute-force
oracle walk instead of a dense vector sweep.  It is exact by construction (it *is* the oracle
restricted to one zone), runs on the host with numpy alone, and is the
cross-check the registry exposes as ``grade="oracle"``.

Intended for small inputs: O(E^2 l_max) per zone, pure Python inner loop.
The executor runs its scan on the host (``host_only=True``) and folds
the results on its device.
"""

from __future__ import annotations

import numpy as np

from . import encoding
from .expansion import ZoneResult


def scan_zone(u, v, t, valid, *, delta: int, l_max: int,
              with_ts: bool = False) -> ZoneResult:
    """Scan one padded zone; returns numpy (code[E, L], length[E])."""
    u = np.asarray(u)
    v = np.asarray(v)
    t = np.asarray(t)
    valid = np.asarray(valid).astype(bool)
    e = u.shape[0]
    limbs = encoding.n_limbs(l_max)
    code = np.zeros((e, limbs), np.int32)
    length = np.zeros(e, np.int32)
    ts = np.zeros((e, l_max), np.int32) if with_ts else None

    idx = np.flatnonzero(valid)
    for si, seed in enumerate(idx):
        edges = [(int(u[seed]), int(v[seed]))]
        nodes = {int(u[seed]), int(v[seed])}
        last_t = int(t[seed])
        times = [last_t]
        j = si + 1
        while len(edges) < l_max:
            extended = False
            while j < len(idx) and int(t[idx[j]]) <= last_t + delta:
                jj = int(idx[j])
                tj = int(t[jj])
                if tj > last_t and (int(u[jj]) in nodes or int(v[jj]) in nodes):
                    edges.append((int(u[jj]), int(v[jj])))
                    nodes.add(int(u[jj]))
                    nodes.add(int(v[jj]))
                    last_t = tj
                    times.append(tj)
                    extended = True
                    j += 1
                    break
                j += 1
            if not extended:
                break
        code[seed] = encoding.encode_process_np(edges, l_max)
        length[seed] = len(edges)
        if ts is not None:
            ts[seed, :len(times)] = times
    return ZoneResult(code=code, length=length, ts=ts)


def scan_zones(u, v, t, valid, *, delta: int, l_max: int,
               with_ts: bool = False) -> ZoneResult:
    """Reference-signature scan over a [Z, E] zone batch (numpy arrays)."""
    u = np.asarray(u)
    v = np.asarray(v)
    t = np.asarray(t)
    valid = np.asarray(valid)
    z, e = u.shape
    limbs = encoding.n_limbs(l_max)
    code = np.zeros((z, e, limbs), np.int32)
    length = np.zeros((z, e), np.int32)
    ts = np.zeros((z, e, l_max), np.int32) if with_ts else None
    for zi in range(z):
        res = scan_zone(u[zi], v[zi], t[zi], valid[zi],
                        delta=delta, l_max=l_max, with_ts=with_ts)
        code[zi] = res.code
        length[zi] = res.length
        if ts is not None:
            ts[zi] = res.ts
    return ZoneResult(code=code, length=length, ts=ts)
