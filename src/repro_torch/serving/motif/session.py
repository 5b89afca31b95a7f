"""One tenant session: a StreamingMiner behind admission + snapshot cache.

A session decouples the tenant-facing arrival rate from the miner's frontier
advance.  Arriving edges land in a cheap **admission buffer** and are flushed
to :meth:`StreamingMiner.ingest` only when ``ingest_batch`` edges have
accumulated (or on an explicit :meth:`flush`) — one sorted `ingest()` per
batch amortizes the per-call Python and device-dispatch overhead that
dominates small-chunk streaming.  The admission window also stable-sorts by
timestamp, so arrivals that are slightly out of order *within* one window
are repaired for free; ordering across windows is still enforced by the
miner.

Queries are served from an epoch-keyed :class:`EpochCache` of
:class:`QueryEngine` objects built over ``miner.snapshot()``.  Because the
miner's ``epoch`` bumps exactly when the closed prefix changes, repeated
queries between finalizations reuse the cached engine (no re-mine) and
invalidation is exact — never time-based.

Consistency model: query answers reflect the **closed prefix of admitted
edges** — everything with ``t < t_head - L_b`` where ``t_head`` is the
newest admitted timestamp (exact by Lemma 4.2, see ``core/streaming.py``).
Edges still in the admission buffer become visible at the next flush.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.config import MiningConfig
from repro_torch.core.streaming import StreamingMiner, validate_edge_chunk
from repro_torch.obs import get_obs

from .cache import EpochCache
from .query import QueryEngine


class MotifSession:
    """A named tenant stream with its own miner, buffer, and cache.

    Mining parameters come in one of three equivalent ways (most to least
    preferred): ``engine=`` — a :class:`repro_torch.core.engine.PTMTEngine`
    whose config *and* executor (so its device) the session's miner
    shares (the serving deployment shape: many tenants, one engine;
    individual kwargs alongside it are per-tenant overrides of the
    engine's config, routed through ``engine.stream(**overrides)``);
    ``config=`` — a validated
    :class:`~repro_torch.core.config.MiningConfig`; or the legacy
    individual kwargs alone (a config is built and validated internally,
    ``delta`` and ``l_max`` required).  ``engine`` and ``config`` together
    are ambiguous and rejected.  Without an engine the miner's executor is
    built on ``device`` (CUDA unless given; with no CUDA device and no
    ``device`` construction raises); an engine brings its own device, and
    ``device`` must then be left out.
    ``ingest_batch`` / ``cache_capacity`` are serving-side knobs and stay
    per-session.
    """

    def __init__(
        self,
        name: str,
        *,
        engine=None,
        config: MiningConfig | None = None,
        delta: int | None = None,
        l_max: int | None = None,
        omega: int | None = None,
        e_cap: int | None = None,
        backend: str | None = None,
        zone_chunk: int | None = None,
        agg: str | None = None,
        merge_cap: int | None = None,
        memory_budget_mb: float | None = None,
        ingest_batch: int = 4096,
        cache_capacity: int = 2,
        device=None,
        obs=None,
    ):
        if ingest_batch < 1:
            raise ValueError("ingest_batch must be >= 1")
        self.name = name
        self.ingest_batch = int(ingest_batch)
        legacy = {k: v for k, v in dict(
            delta=delta, l_max=l_max, omega=omega, e_cap=e_cap,
            backend=backend, zone_chunk=zone_chunk, agg=agg,
            merge_cap=merge_cap, memory_budget_mb=memory_budget_mb,
        ).items() if v is not None}
        if engine is not None:
            if config is not None:
                raise ValueError(
                    "pass either an engine or a config, not both")
            if device is not None:
                raise ValueError(
                    "an engine brings its own device; pass either an "
                    "engine or a device, not both")
            self.miner = engine.stream(**legacy)
        else:
            self.miner = StreamingMiner(config=config, device=device,
                                        **legacy)
        # NB: distinct from the .engine() *method*, which returns the
        # per-epoch QueryEngine — mining_engine is the PTMTEngine this
        # session was built from (None on the config/kwargs paths)
        self.mining_engine = engine
        # obs resolution: explicit bundle > shared engine's > miner's own
        # (NULL unless the miner was given one).  When the session's bundle
        # is live and the miner's is not, adopt it on the miner too so
        # stream.* spans and gauges land in the same export.
        if obs is not None:
            self.obs = get_obs(obs)
        elif engine is not None:
            self.obs = engine.obs
        else:
            self.obs = self.miner.obs
        if self.obs.enabled and not self.miner.obs.enabled:
            self.miner.obs = self.obs
        # tag the miner's metric series with the tenant name
        self.miner.obs_label = name
        self.config = self.miner.config
        self.cache = EpochCache(cache_capacity)
        self.lock = threading.RLock()
        self._pend_u: list[np.ndarray] = []
        self._pend_v: list[np.ndarray] = []
        self._pend_t: list[np.ndarray] = []
        self._pending = 0
        self.edges_accepted = 0
        self.edges_discarded = 0
        self.flushes = 0
        self.snapshots_mined = 0
        self.queries = 0

    # -- state --------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.miner.epoch

    @property
    def closed_time(self) -> int | None:
        return self.miner.closed_time

    @property
    def pending_edges(self) -> int:
        return self._pending

    # -- ingest path --------------------------------------------------------

    def ingest(self, u, v, t) -> bool:
        """Buffer one edge chunk; returns True if it triggered a flush.

        Chunks are validated *before* buffering (integer dtypes, values in
        int32/int64 range — see :func:`validate_edge_chunk`); a bad chunk
        raises ``ValueError`` and leaves the admission window untouched.
        """
        u, v, t = validate_edge_chunk(u, v, t)
        with self.lock:
            if t.size:
                self._pend_u.append(u)
                self._pend_v.append(v)
                self._pend_t.append(t)
                self._pending += int(t.size)
                self.edges_accepted += int(t.size)
            if self._pending >= self.ingest_batch:
                self._flush_locked()
                return True
            self._note_pending()
            return False

    def flush(self) -> int:
        """Admit everything buffered; returns the number of edges admitted."""
        with self.lock:
            return self._flush_locked()

    def discard_pending(self) -> int:
        """Drop the not-yet-admitted window; returns the edges discarded.

        The recovery path after a rejected flush (an edge older than the
        stream head): without it the bad window would poison every later
        flush.  Admitted state is untouched.
        """
        with self.lock:
            n = self._pending
            self._pend_u, self._pend_v, self._pend_t = [], [], []
            self._pending = 0
            self.edges_discarded += n
            self._note_pending()
            return n

    def _note_pending(self) -> None:
        if self.obs.enabled:
            self.obs.metrics.gauge("repro_serving_pending_edges",
                                   tenant=self.name).set(self._pending)

    def _flush_locked(self) -> int:
        n = self._pending
        if n == 0:
            return 0
        u = np.concatenate(self._pend_u)
        v = np.concatenate(self._pend_v)
        t = np.concatenate(self._pend_t)
        order = np.argsort(t, kind="stable")
        # the miner validates ordering before mutating any state, so on a
        # rejected window (e.g. an edge older than the stream head) the
        # buffer is kept intact for the caller to inspect or drop — edges
        # are never silently lost
        with self.obs.tracer.span("serve.flush", tenant=self.name, edges=n):
            self.miner.ingest(u[order], v[order], t[order])
        self._pend_u, self._pend_v, self._pend_t = [], [], []
        self._pending = 0
        self.flushes += 1
        self._note_pending()
        return n

    # -- query path ---------------------------------------------------------

    def engine(self) -> QueryEngine:
        """Engine for the current epoch; mines a snapshot only on cache miss.

        The miss path mines **outside** the session lock: the lock is held
        only to freeze an immutable :class:`~repro_torch.core.streaming.
        SnapshotView` of the closed prefix (O(#codes), no device work) and
        again to compare-and-swap the mined engine into the cache — so the
        first query of an epoch no longer stalls concurrent ``ingest`` for
        the duration of the mine (regression-tested in
        ``tests/test_torch_serving.py``).  If two queries race the same
        cold epoch both mine, but only the first CAS wins and both return
        the winning engine; equal epochs guarantee equal snapshots, so the
        loser's work is redundant, never wrong.  The returned engine is
        immutable and stamped with its epoch, so everything after the
        fetch (query evaluation, lazy index builds) also runs lock-free.
        """
        with self.lock:
            self.queries += 1
            epoch = self.miner.epoch
            engine = self.cache.get(epoch)
            if engine is not None:
                self.obs.metrics.counter(
                    "repro_serving_snapshot_cache_hits_total",
                    tenant=self.name).inc()
                return engine
            view = self.miner.freeze()
        # device mining happens here, with the lock RELEASED — ingest
        # proceeds concurrently against the buffers the view froze
        with self.obs.tracer.span("serve.snapshot",
                                  tenant=self.name, epoch=epoch):
            result, tail = self.miner.mine_view(view)
        engine = QueryEngine(result, epoch=epoch)
        with self.lock:
            self.miner.adopt_tail(view, tail)
            self.snapshots_mined += 1
            self.obs.metrics.counter(
                "repro_serving_snapshot_cache_misses_total",
                tenant=self.name).inc()
            current = self.cache.peek(epoch)
            if current is None:
                self.cache.put(epoch, engine)
            else:
                engine = current     # a racing query won the CAS; serve its
            return engine            # engine (identical counts by epoch)

    # -- checkpoint/restore --------------------------------------------------

    def checkpoint_state(self) -> dict:
        """Consistent durable capture of this tenant's state.

        Taken under the session lock, so the miner state and the admission
        window are from one instant: the miner's
        :meth:`~repro_torch.core.streaming.StreamingMiner.state_dict` plus
        the not-yet-admitted pending edges and the ingest-side counters.
        Query-side state (snapshot cache, query counters) is deliberately
        *not* durable — it is a pure re-derivable function of the miner
        state and rebuilds on first use after restore.
        """
        with self.lock:
            if self._pending:
                pend_u = np.concatenate(self._pend_u)
                pend_v = np.concatenate(self._pend_v)
                pend_t = np.concatenate(self._pend_t)
            else:
                pend_u = np.zeros(0, np.int32)
                pend_v = np.zeros(0, np.int32)
                pend_t = np.zeros(0, np.int64)
            return {
                "name": self.name,
                "miner": self.miner.state_dict(),
                "pend_u": pend_u, "pend_v": pend_v, "pend_t": pend_t,
                "edges_accepted": self.edges_accepted,
                "edges_discarded": self.edges_discarded,
                "flushes": self.flushes,
            }

    def restore_state(self, state: dict) -> None:
        """Install a :meth:`checkpoint_state` capture into this session.

        Restore into a **freshly built** session for the same tenant name
        (the manager's ``restore`` does this): the miner validates that
        its config and tail-layout signature match the checkpointed ones,
        the admission window is re-buffered, and ingest-side counters
        resume.  Continuing the same edge stream afterwards yields state
        byte-identical to a session that never stopped.
        """
        if state["name"] != self.name:
            raise ValueError(
                f"checkpoint is for tenant {state['name']!r}, "
                f"not {self.name!r}")
        u, v, t = validate_edge_chunk(
            state["pend_u"], state["pend_v"], state["pend_t"])
        with self.lock:
            self.miner.restore_state(state["miner"])
            self._pend_u = [u] if t.size else []
            self._pend_v = [v] if t.size else []
            self._pend_t = [t] if t.size else []
            self._pending = int(t.size)
            self.edges_accepted = int(state["edges_accepted"])
            self.edges_discarded = int(state["edges_discarded"])
            self.flushes = int(state["flushes"])
            self._note_pending()

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        with self.lock:
            return {
                "name": self.name,
                "epoch": self.miner.epoch,
                "edges_accepted": self.edges_accepted,
                "edges_discarded": self.edges_discarded,
                "edges_admitted": self.miner.n_edges_ingested,
                "pending_edges": self._pending,
                "flushes": self.flushes,
                "zones_finalized": self.miner.n_zones_finalized,
                "edges_retired": self.miner.n_edges_retired,
                "buffered_edges": self.miner.buffered_edges,
                "queries": self.queries,
                "snapshots_mined": self.snapshots_mined,
                "cache": self.cache.stats(),
                # miner-level reuse of finalized partial counts + the
                # open-tail mine (exact, epoch-keyed — even when this
                # session's engine cache evicted the epoch, a re-snapshot
                # within the same epoch does no device mining)
                "tail_cache_hits": self.miner.tail_cache_hits,
                "tail_cache_misses": self.miner.tail_cache_misses,
            }
