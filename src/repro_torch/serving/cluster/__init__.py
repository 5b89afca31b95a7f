"""Cluster availability layer over the motif serving stack.

Modules (bottom up):

* :mod:`.checkpoint` — :class:`SessionCheckpoint` / :class:`CheckpointStore`:
  versioned, CRC-verified, atomically-written per-tenant durability;
  restore replays only the open tail and is byte-identical.
* :mod:`.placement`  — rendezvous hashing: deterministic tenant → worker
  ownership with minimal movement on membership change.
* :mod:`.admission`  — :class:`AdmissionController`: per-tenant + global
  pending-edge budgets surfacing an explicit throttle signal.
* :mod:`.coordinator` — :class:`ClusterWorker` / :class:`ClusterCoordinator`:
  N disjoint serving stacks behind one routing surface, with
  checkpoint-driven failover and restart.
"""

from .admission import AdmissionController, AdmissionDecision
from .checkpoint import (
    FORMAT_VERSION,
    CheckpointError,
    CheckpointStore,
    SessionCheckpoint,
)
from .coordinator import (
    ClusterAck,
    ClusterCoordinator,
    ClusterWorker,
    WorkerDown,
)
from .placement import place, rendezvous_owner

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "CheckpointError",
    "CheckpointStore",
    "ClusterAck",
    "ClusterCoordinator",
    "ClusterWorker",
    "FORMAT_VERSION",
    "SessionCheckpoint",
    "WorkerDown",
    "place",
    "rendezvous_owner",
]
