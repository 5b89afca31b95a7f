"""Service front: a dataclass request/response protocol over the manager.

:class:`MotifService` is the single surface a transport (HTTP handler, RPC
stub, the replay driver in ``launch/serve_motifs.py``) talks to.  Requests
and responses are plain frozen dataclasses so they serialize trivially and
the protocol is testable without any network layer.  Every response carries
the snapshot ``epoch`` it was answered at — the consistency token a client
can use to correlate answers across queries — plus the server-side latency.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.obs import get_obs

from .manager import SessionManager
from .query import QueryEngine

#: Query operations understood by :meth:`MotifService.query`.
QUERY_OPS = ("top_k", "transition_probs", "prefix_count", "level_histogram",
             "total")


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One analytics query against a tenant session."""

    session: str
    op: str                      # one of QUERY_OPS
    code: str = ""               # motif code for transition/prefix ops
    level: int | None = None     # level filter for top_k
    k: int = 10                  # result bound for top_k


@dataclasses.dataclass(frozen=True)
class QueryResponse:
    session: str
    op: str
    epoch: int                   # snapshot epoch the answer reflects
    latency_s: float
    payload: object
    #: True when this was the first query of its (session, op) pair —
    #: ``latency_s`` then includes one-time costs (the kernels' first
    #: build and load, lazy index builds) that steady-state percentiles
    #: must exclude.
    first_call: bool = False


@dataclasses.dataclass(frozen=True)
class IngestAck:
    session: str
    accepted: int                # edges buffered by this call
    flushed: bool                # did this call trigger a batch admission
    epoch: int                   # session epoch after the call


class MotifService:
    """Multi-tenant motif analytics over streaming discovery.

    ``manager_kwargs`` flow into :class:`SessionManager` as session
    defaults — ``MotifService(engine=PTMTEngine(cfg), ingest_batch=8192)``
    is the standard deployment: every tenant session mines through the one
    shared engine (one resolved backend, one device).  Without an engine,
    ``device=`` among them places every session's miner (CUDA unless
    given; with no CUDA device and no ``device`` a session's construction
    raises).
    """

    def __init__(self, manager: SessionManager | None = None, *,
                 obs=None, **manager_kwargs):
        if manager is not None and manager_kwargs:
            raise ValueError("pass either a manager or manager kwargs")
        # the bundle is both the service's own sink (query latency
        # histograms) and the default for every tenant session (it rides
        # the manager's session_defaults into MotifSession(obs=...))
        self.obs = get_obs(obs)
        if manager is None and self.obs.enabled:
            manager_kwargs.setdefault("obs", self.obs)
        self.manager = manager or SessionManager(**manager_kwargs)
        # (session, op) pairs that have answered at least one query — the
        # first query pays one-time build/index cost and is reported as
        # first_call instead of polluting steady-state latency
        self._warm: set[tuple[str, str]] = set()
        self._warm_lock = threading.Lock()

    # -- tenant lifecycle ---------------------------------------------------

    def create_session(self, name: str, **params):
        return self.manager.create(name, **params)

    def drop_session(self, name: str):
        session = self.manager.drop(name)
        # a re-created tenant starts cold again: forget its warm pairs
        with self._warm_lock:
            self._warm = {k for k in self._warm if k[0] != name}
        return session

    def sessions(self) -> list[str]:
        return self.manager.names()

    # -- ingest -------------------------------------------------------------

    def ingest(self, session: str, u, v, t) -> IngestAck:
        sess = self.manager.get(session)
        # count after the same normalization the session applies, so acks
        # agree with session stats for scalars and multi-dim chunks alike
        n = int(np.asarray(t).size)
        flushed = sess.ingest(u, v, t)
        return IngestAck(session=session, accepted=n, flushed=flushed,
                         epoch=sess.epoch)

    def flush(self, session: str) -> IngestAck:
        sess = self.manager.get(session)
        n = sess.flush()
        return IngestAck(session=session, accepted=n, flushed=n > 0,
                         epoch=sess.epoch)

    def flush_all(self) -> list[IngestAck]:
        acks = []
        for name in self.manager.names():
            try:
                acks.append(self.flush(name))
            except KeyError:       # tenant dropped concurrently — skip it
                continue
        return acks

    def discard_pending(self, session: str) -> int:
        """Drop a session's not-yet-admitted window (rejected-flush
        recovery)."""
        return self.manager.get(session).discard_pending()

    # -- cross-tenant co-mining ---------------------------------------------

    def comine(self, graph, sessions: list[str] | None = None) -> dict:
        """Batch-mine one graph under every (or the named) tenants' configs.

        Thin delegate to :meth:`SessionManager.comine`: tenant configs that
        differ only in ``delta``/``l_max``/``omega`` share one Phase-1 sweep
        via ``PTMTEngine.discover_many``.  Returns
        ``{tenant_name: DiscoveryResult}`` with counts byte-identical to
        per-tenant independent mining.
        """
        with self.obs.tracer.span("serve.comine",
                                  tenants=len(sessions or self.sessions())):
            return self.manager.comine(graph, sessions)

    # -- query --------------------------------------------------------------

    def query(self, request: QueryRequest) -> QueryResponse:
        if request.op not in QUERY_OPS:
            raise ValueError(
                f"unknown op {request.op!r}; expected one of {QUERY_OPS}"
            )
        sess = self.manager.get(request.session)
        with self._warm_lock:
            first_call = (request.session, request.op) not in self._warm
            if first_call:
                self._warm.add((request.session, request.op))
        with self.obs.tracer.span("serve.query", tenant=request.session,
                                  op=request.op):
            t0 = time.perf_counter()
            # engine() holds the session lock for the cache lookup (and, on
            # the first query of an epoch, the snapshot mine — see
            # MotifSession.engine); dispatch then runs lock-free against
            # the immutable snapshot, so query evaluation itself never
            # blocks ingest
            engine = sess.engine()
            payload = self._dispatch(engine, request)
            latency_s = time.perf_counter() - t0
        # first calls carry one-time build/index cost; route them
        # to their own histogram so the steady-state series stays honest
        name = ("repro_serving_query_first_call_ms" if first_call
                else "repro_serving_query_latency_ms")
        self.obs.metrics.histogram(
            name, tenant=request.session, op=request.op,
        ).observe(latency_s * 1e3)
        return QueryResponse(
            session=request.session, op=request.op, epoch=engine.epoch,
            latency_s=latency_s, payload=payload, first_call=first_call,
        )

    @staticmethod
    def _dispatch(engine: QueryEngine, request: QueryRequest):
        if request.op == "top_k":
            return engine.top_k_motifs(level=request.level, k=request.k)
        if request.op == "transition_probs":
            return engine.transition_probs(request.code)
        if request.op == "prefix_count":
            return engine.prefix_count(request.code)
        if request.op == "level_histogram":
            return engine.level_histogram()
        return engine.total_processes()            # "total"

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        return self.manager.stats()
