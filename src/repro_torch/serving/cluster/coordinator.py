"""Cluster layer: N workers, rendezvous placement, checkpoint failover.

Topology: a :class:`ClusterCoordinator` owns N :class:`ClusterWorker`\\ s.
Each worker is a full serving stack — its own
:class:`~repro_torch.core.engine.PTMTEngine` (own executor, on the
device the worker was given), :class:`~repro_torch.serving.motif.
MotifService`, and :class:`~repro_torch.serving.cluster.admission.
AdmissionController` — so worker
state is genuinely disjoint: killing one loses exactly its tenants'
in-memory state and nothing else, which is what makes the failover test
meaningful.  Workers here are thread-hosted service instances behind one
routing surface; the worker API (create/restore/ingest/query/checkpoint)
is the process boundary a transport would serialize over, and the
restart harness exercises the real-process version of the same story
(kill -9, new process, restore from disk).

Routing: tenant → worker by rendezvous hashing
(:mod:`~repro_torch.serving.cluster.placement`) over the *live* worker
set.
On worker death only the dead worker's tenants re-home; each is restored
on its new owner from its latest on-disk checkpoint
(:class:`~repro_torch.serving.cluster.checkpoint.CheckpointStore`) and
the
caller gets back each tenant's checkpoint ``meta`` (the harness stores
stream offsets there) so the feed can rewind to exactly the durable
point.  Counts after replay are byte-identical to an undisturbed run —
TZP finalization is deterministic, and the checkpoint captures every
input the remaining stream suffix will interact with.

Backpressure: every ingest is offered to the owning worker's admission
controller first; over-budget chunks come back ``throttled=True`` in the
:class:`ClusterAck` without buffering anything, and the caller defers.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.obs import get_obs
from repro_torch.serving.motif import MotifService

from .admission import AdmissionController
from .checkpoint import CheckpointError, CheckpointStore, SessionCheckpoint
from .placement import rendezvous_owner


class WorkerDown(RuntimeError):
    """The routed-to worker has been killed."""


@dataclasses.dataclass(frozen=True)
class ClusterAck:
    """Result of one cluster-routed ingest offer."""

    tenant: str
    worker: str
    accepted: int              # edges buffered (0 when throttled)
    flushed: bool              # did this call trigger a batch admission
    epoch: int                 # tenant epoch after the call
    throttled: bool = False
    reason: str = "ok"         # binding budget when throttled
    pending: int = 0           # tenant's pending edges after the call


class ClusterWorker:
    """One worker: engine + service + admission, with a liveness flag.

    ``kill()`` flips ``alive`` and every later call raises
    :class:`WorkerDown` — the in-memory sessions still exist as Python
    objects but are unreachable through the API, modelling a crashed
    process whose state is recoverable only from checkpoints.

    ``device`` places the engine built from ``config`` (and, without
    either, every session's miner): CUDA unless given; with no CUDA
    device and no ``device`` construction raises.
    """

    def __init__(self, worker_id: str, *, engine=None, config=None,
                 tenant_budget: int | None = 65536,
                 global_budget: int | None = None,
                 mesh=None, mesh_axes=None, device=None, obs=None,
                 **session_defaults):
        if engine is None and config is not None:
            from repro_torch.core.engine import PTMTEngine

            engine = PTMTEngine(config, device=device, obs=obs)
        self.worker_id = worker_id
        self.engine = engine
        self.obs = get_obs(obs)
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        kwargs = dict(session_defaults)
        if engine is not None:
            kwargs["engine"] = engine
        elif device is not None:
            kwargs["device"] = device
        self.service = MotifService(obs=obs, **kwargs)
        self.admission = AdmissionController(
            tenant_budget=tenant_budget, global_budget=global_budget,
            obs=obs)
        self.alive = True

    def _check(self) -> None:
        if not self.alive:
            raise WorkerDown(f"worker {self.worker_id!r} is down")

    def kill(self) -> None:
        self.alive = False

    # -- tenant lifecycle ----------------------------------------------------

    def create_session(self, tenant: str, **params):
        self._check()
        return self.service.create_session(tenant, **params)

    def restore_session(self, state: dict, **params):
        self._check()
        session = self.service.manager.restore(state, **params)
        self.admission.settle(state["name"], session.pending_edges)
        return session

    def drop(self, tenant: str):
        self._check()
        session = self.service.drop_session(tenant)
        self.admission.forget(tenant)
        return session

    def tenants(self) -> list[str]:
        self._check()
        return self.service.sessions()

    # -- data path -----------------------------------------------------------

    def ingest(self, tenant: str, u, v, t) -> ClusterAck:
        self._check()
        n = int(np.asarray(t).size)
        decision = self.admission.offer(tenant, n)
        session = self.service.manager.get(tenant)
        if not decision:
            return ClusterAck(
                tenant=tenant, worker=self.worker_id, accepted=0,
                flushed=False, epoch=session.epoch, throttled=True,
                reason=decision.reason, pending=session.pending_edges)
        ack = self.service.ingest(tenant, u, v, t)
        pending = session.pending_edges
        # flushes inside the call repay debt immediately — reconcile to
        # the session's true window so throttling never runs on stale debt
        self.admission.settle(tenant, pending)
        return ClusterAck(
            tenant=tenant, worker=self.worker_id, accepted=ack.accepted,
            flushed=ack.flushed, epoch=ack.epoch, pending=pending)

    def flush(self, tenant: str):
        self._check()
        ack = self.service.flush(tenant)
        self.admission.settle(tenant, 0)
        return ack

    def query(self, request):
        self._check()
        return self.service.query(request)

    def comine(self, graph, tenants: list[str] | None = None) -> dict:
        self._check()
        return self.service.comine(graph, tenants)

    def sharded_mine(self, graph, **kw):
        """Batch mine on this worker's device mesh (intra-worker sharding).

        With a mesh configured this is ``engine.sharded`` — zones sharded
        over the mesh's ranks via the ``distributed/`` SPMD step — and a
        plain warm ``engine.discover`` otherwise.  Counts are identical
        either way.
        """
        self._check()
        if self.engine is None:
            raise RuntimeError(
                f"worker {self.worker_id!r} has no engine; batch mining "
                f"needs an engine= or config= at construction")
        if self.mesh is not None:
            return self.engine.sharded(graph, self.mesh, self.mesh_axes,
                                       **kw)
        return self.engine.discover(graph)

    # -- durability ----------------------------------------------------------

    def checkpoint(self, tenant: str,
                   meta: dict | None = None) -> SessionCheckpoint:
        self._check()
        return SessionCheckpoint.capture(
            self.service.manager.get(tenant), meta)

    def stats(self) -> dict:
        return {
            "worker": self.worker_id,
            "alive": self.alive,
            "service": self.service.stats() if self.alive else None,
            "admission": self.admission.stats(),
        }


class ClusterCoordinator:
    """Routes tenants across workers; rebalances from checkpoints on death.

    Every worker's engine (or, without a ``config``, every session) runs
    on ``device``: CUDA unless given, raising without a CUDA device.
    """

    def __init__(self, n_workers: int = 2, *, config=None,
                 store: CheckpointStore | None = None,
                 checkpoint_dir: str | None = None,
                 tenant_budget: int | None = 65536,
                 global_budget: int | None = None,
                 mesh=None, mesh_axes=None, device=None, obs=None,
                 **session_defaults):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if store is not None and checkpoint_dir is not None:
            raise ValueError("pass either store or checkpoint_dir, not both")
        self.obs = get_obs(obs)
        self.store = store or (
            CheckpointStore(checkpoint_dir) if checkpoint_dir else None)
        self.workers: dict[str, ClusterWorker] = {
            f"w{i}": ClusterWorker(
                f"w{i}", config=config, tenant_budget=tenant_budget,
                global_budget=global_budget, mesh=mesh, mesh_axes=mesh_axes,
                device=device, obs=obs, **session_defaults)
            for i in range(n_workers)
        }
        self._placement: dict[str, str] = {}
        self._lock = threading.Lock()
        self.failovers = 0
        self.tenants_lost = 0

    # -- membership ----------------------------------------------------------

    def live_workers(self) -> list[str]:
        return sorted(w for w, obj in self.workers.items() if obj.alive)

    def owner_of(self, tenant: str) -> str:
        with self._lock:
            try:
                return self._placement[tenant]
            except KeyError:
                raise KeyError(f"unknown tenant {tenant!r}") from None

    def _worker_for(self, tenant: str) -> ClusterWorker:
        return self.workers[self.owner_of(tenant)]

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._placement)

    # -- tenant lifecycle ----------------------------------------------------

    def create_tenant(self, tenant: str, **params):
        with self._lock:
            if tenant in self._placement:
                raise ValueError(f"tenant {tenant!r} already placed")
            owner = rendezvous_owner(tenant, self.live_workers())
            self._placement[tenant] = owner
        try:
            return self.workers[owner].create_session(tenant, **params)
        except BaseException:
            with self._lock:
                if self._placement.get(tenant) == owner:
                    del self._placement[tenant]
            raise

    def drop_tenant(self, tenant: str):
        worker = self._worker_for(tenant)
        session = worker.drop(tenant)
        with self._lock:
            self._placement.pop(tenant, None)
        if self.store is not None:
            self.store.delete(tenant)
        return session

    # -- data path -----------------------------------------------------------

    def ingest(self, tenant: str, u, v, t) -> ClusterAck:
        return self._worker_for(tenant).ingest(tenant, u, v, t)

    def flush(self, tenant: str):
        return self._worker_for(tenant).flush(tenant)

    def flush_all(self) -> None:
        for tenant in self.tenants():
            try:
                self.flush(tenant)
            except KeyError:
                continue

    def query(self, request):
        return self._worker_for(request.session).query(request)

    def comine(self, graph, tenants: list[str] | None = None) -> dict:
        """Co-mine one graph per tenant config, grouped by owning worker.

        Tenants co-located on a worker share that worker's lattice sweep
        (``PTMTEngine.discover_many``); groups on different workers are
        independent mines.  Returns ``{tenant: DiscoveryResult}``.
        """
        selected = self.tenants() if tenants is None else list(tenants)
        by_worker: dict[str, list[str]] = {}
        for tenant in selected:
            by_worker.setdefault(self.owner_of(tenant), []).append(tenant)
        out: dict = {}
        for worker_id, group in by_worker.items():
            out.update(self.workers[worker_id].comine(graph, group))
        return out

    # -- durability & failover -----------------------------------------------

    def _require_store(self) -> CheckpointStore:
        if self.store is None:
            raise CheckpointError(
                "no checkpoint store configured (pass store= or "
                "checkpoint_dir= to ClusterCoordinator)")
        return self.store

    def checkpoint(self, tenant: str, meta: dict | None = None) -> str:
        store = self._require_store()
        ckpt = self._worker_for(tenant).checkpoint(tenant, meta)
        return store.save(ckpt)

    def checkpoint_all(
            self, metas: dict[str, dict] | None = None) -> dict[str, str]:
        """Checkpoint every tenant; ``metas[tenant]`` rides along if given."""
        metas = metas or {}
        return {tenant: self.checkpoint(tenant, metas.get(tenant))
                for tenant in self.tenants()}

    def kill_worker(self, worker_id: str) -> dict[str, dict | None]:
        """Kill a worker and fail its tenants over from their checkpoints.

        Each victim tenant re-homes to its rendezvous runner-up among the
        surviving workers and is restored from its latest on-disk
        checkpoint.  Returns ``{tenant: checkpoint_meta}`` so the caller
        can rewind each tenant's feed to the durable point (the harness
        stores stream offsets in ``meta``).  A tenant with no checkpoint
        on disk is *lost* — mapped to ``None`` and removed — because a
        crashed worker's memory is by definition unrecoverable.
        """
        worker = self.workers[worker_id]
        if not worker.alive:
            raise WorkerDown(f"worker {worker_id!r} is already down")
        worker.kill()
        with self._lock:
            victims = sorted(t for t, w in self._placement.items()
                             if w == worker_id)
        live = self.live_workers()
        if victims and not live:
            raise RuntimeError("no surviving workers to fail over to")
        recovered: dict[str, dict | None] = {}
        for tenant in victims:
            try:
                ckpt = self._require_store().load(tenant)
            except CheckpointError:
                with self._lock:
                    del self._placement[tenant]
                self.tenants_lost += 1
                if self.obs.enabled:
                    self.obs.metrics.counter(
                        "repro_cluster_tenants_lost_total").inc()
                recovered[tenant] = None
                continue
            new_owner = rendezvous_owner(tenant, live)
            self.workers[new_owner].restore_session(ckpt.payload)
            with self._lock:
                self._placement[tenant] = new_owner
            self.failovers += 1
            if self.obs.enabled:
                self.obs.metrics.counter(
                    "repro_cluster_failovers_total",
                    src=worker_id, dst=new_owner).inc()
            recovered[tenant] = ckpt.meta
        return recovered

    def restore_all(self) -> dict[str, dict]:
        """Cold-start path: place + restore every checkpointed tenant.

        A fresh coordinator pointed at an existing checkpoint directory
        rebuilds the whole tenant set (the restart harness after a kill
        -9).  Returns ``{tenant: checkpoint_meta}`` for feed rewind.
        """
        store = self._require_store()
        live = self.live_workers()
        recovered: dict[str, dict] = {}
        for tenant in store.tenants():
            ckpt = store.load(tenant)
            owner = rendezvous_owner(tenant, live)
            self.workers[owner].restore_session(ckpt.payload)
            with self._lock:
                self._placement[tenant] = owner
            recovered[tenant] = ckpt.meta
        return recovered

    # -- reporting -----------------------------------------------------------

    def placement(self) -> dict[str, str]:
        with self._lock:
            return dict(self._placement)

    def stats(self) -> dict:
        per_worker = {w: obj.stats() for w, obj in self.workers.items()}
        return {
            "n_workers": len(self.workers),
            "live_workers": self.live_workers(),
            "placement": self.placement(),
            "failovers": self.failovers,
            "tenants_lost": self.tenants_lost,
            "workers": per_worker,
        }
