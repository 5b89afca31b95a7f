"""Tenant → worker placement by rendezvous (highest-random-weight) hashing.

Every participant can compute the owner of any tenant locally from just
the live worker set — no placement table to replicate, no coordination
round.  The property the cluster layer actually relies on is *minimal
movement*: when a worker dies, only the tenants it owned re-home (each to
its runner-up worker); every other tenant's placement is untouched, so a
failover restores exactly the dead worker's checkpoints and nothing else.

Scores are derived from ``blake2b`` digests, **not** Python's builtin
``hash`` — placement must be identical across processes and restarts
(``PYTHONHASHSEED`` randomizes ``hash``), because a restarted coordinator
recomputes ownership from the checkpoint directory alone.
"""

from __future__ import annotations

import hashlib


def score(worker: str, tenant: str) -> int:
    """Deterministic rendezvous weight of ``worker`` for ``tenant``."""
    digest = hashlib.blake2b(
        f"{worker}\x00{tenant}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


def rendezvous_owner(tenant: str, workers) -> str:
    """The worker owning ``tenant`` among ``workers`` (highest weight).

    Ties break on the worker id itself so the choice is total and
    deterministic even in the astronomically unlikely digest collision.
    """
    pool = list(workers)
    if not pool:
        raise ValueError(f"no live workers to place tenant {tenant!r}")
    return max(pool, key=lambda w: (score(w, tenant), w))


def place(tenants, workers) -> dict[str, str]:
    """Full placement map ``{tenant: owner}`` for the given worker set."""
    pool = list(workers)
    return {t: rendezvous_owner(t, pool) for t in tenants}
