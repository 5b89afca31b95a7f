"""Multi-tenant session registry.

The manager owns the name -> :class:`MotifSession` mapping and nothing else:
per-session concurrency lives on each session's lock, so tenants never
contend with each other on the hot ingest/query paths — the manager lock is
held only for registry mutations and listings.  Session *construction* is
deliberately outside the lock: building a :class:`MotifSession` can resolve
a backend and a device and validate a config, and one slow (or
failing) tenant must not stall every other tenant's ``create``/``get``.
The name is reserved under the lock first, so concurrent creates of the
same name still race safely.
"""

from __future__ import annotations

import threading

from .session import MotifSession

#: Placeholder parked in the registry while a session is being constructed
#: outside the manager lock.  Reserved names count toward ``max_sessions``
#: and reject duplicate ``create`` calls, but are invisible to ``get`` /
#: ``drop`` / ``names`` / ``stats`` until construction commits.
_RESERVED = object()


class SessionManager:
    """Hosts many named tenant sessions with a bounded session count."""

    def __init__(self, *, max_sessions: int = 64, **session_defaults):
        """``session_defaults`` seed every :meth:`create` call — typically
        ``engine=`` (one shared :class:`repro_torch.core.engine.PTMTEngine`,
        the multi-tenant deployment shape: each session's miner shares the
        engine's executor and device) or ``config=`` (with ``device=``)
        plus serving knobs like ``ingest_batch``; per-tenant
        ``create(**params)`` overrides win.  ``obs=`` (an
        :class:`repro_torch.obs.Observability` bundle) is a valid default
        too — every tenant session then emits into one registry, with
        per-tenant series split by the ``tenant`` label."""
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self.max_sessions = int(max_sessions)
        self.session_defaults = dict(session_defaults)
        self._sessions: dict[str, MotifSession] = {}
        self._lock = threading.Lock()
        # lazily-built fallback engine for comine() when tenants don't
        # share a mining engine (config/kwargs-built sessions)
        self._comine_engine = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def create(self, name: str, **params) -> MotifSession:
        """Create a tenant session; defaults fill any unspecified params.

        The name is reserved under the manager lock, then the session is
        constructed with the lock *released* — a slow or failing construct
        never blocks other tenants.  On any construction failure the
        reservation is rolled back, so the name is immediately reusable.
        """
        merged = {**self.session_defaults, **params}
        return self._admit(name, lambda: MotifSession(name, **merged))

    def restore(self, state: dict, **params) -> MotifSession:
        """Rebuild a tenant session from a checkpointed state capture.

        ``state`` is a :meth:`MotifSession.checkpoint_state` dict (the
        cluster layer hands over the decoded payload of a
        :class:`~repro_torch.serving.cluster.checkpoint.SessionCheckpoint`).
        A fresh session is built for the checkpointed config — when the
        manager's defaults carry a shared ``engine=``, the checkpointed
        config is expressed as per-tenant overrides of the engine's config
        so the executor is still shared whenever the configs agree —
        and the captured miner + admission state is installed before the
        session becomes visible to ``get``/``names``.  Restored counts are
        byte-identical to a session that never stopped (asserted in
        ``tests/test_torch_cluster.py``).

        A checkpoint written by the JAX package restores here when its
        backend exists in both packages (``ref``, ``numpy``); one that
        names a backend this package lacks (``pallas``, ``xla``) raises
        ``ValueError`` naming it: a checkpoint pins the backend its
        counts were mined with, so none is swapped for another silently.
        """
        from repro_torch.core import backends
        from repro_torch.core.config import MiningConfig

        name = state["name"]
        raw = state["miner"]["config"]
        for field in ("backend", "fused_backend"):
            value = raw.get(field, "auto")
            if value != "auto" and value not in backends.available_backends():
                raise ValueError(
                    f"checkpoint of tenant {name!r} names {field} "
                    f"{value!r}, which this package does not have "
                    f"(available: {backends.available_backends()}); a "
                    f"checkpoint restores only on the backend it was "
                    f"written with, and {value!r} is not mapped to "
                    f"another silently")
        cfg = MiningConfig.from_json(raw)
        merged = {**self.session_defaults, **params}
        if merged.get("engine") is not None:
            # per-tenant overrides of the shared engine's config; empty
            # when they agree, so the warm executor is shared
            eng_cfg = merged["engine"].config
            merged.update({
                k: v for k, v in cfg.to_dict().items()
                if getattr(eng_cfg, k) != v
            })
        else:
            merged.pop("config", None)
            merged["config"] = cfg

        def build() -> MotifSession:
            session = MotifSession(name, **merged)
            session.restore_state(state)
            return session

        return self._admit(name, build)

    def _admit(self, name: str, build) -> MotifSession:
        """Reserve ``name``, run ``build()`` outside the lock, publish."""
        with self._lock:
            if name in self._sessions:
                raise ValueError(f"session {name!r} already exists")
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    f"session limit reached ({self.max_sessions}); "
                    f"drop a tenant before creating {name!r}"
                )
            self._sessions[name] = _RESERVED
        try:
            session = build()
        except BaseException:
            with self._lock:
                if self._sessions.get(name) is _RESERVED:
                    del self._sessions[name]
            raise
        with self._lock:
            self._sessions[name] = session
        return session

    def get(self, name: str) -> MotifSession:
        with self._lock:
            session = self._sessions.get(name)
        if session is None or session is _RESERVED:
            raise KeyError(f"unknown session {name!r}")
        return session

    def drop(self, name: str) -> MotifSession:
        """Remove and return a session (its miner state stays usable)."""
        with self._lock:
            session = self._sessions.get(name)
            if session is None or session is _RESERVED:
                # a reservation is an in-flight create, not a droppable
                # session — callers see it only once construction commits
                raise KeyError(f"unknown session {name!r}")
            del self._sessions[name]
            return session

    def names(self) -> list[str]:
        with self._lock:
            return sorted(n for n, s in self._sessions.items()
                          if s is not _RESERVED)

    def _snapshot(self) -> list[MotifSession]:
        with self._lock:
            return [s for s in self._sessions.values() if s is not _RESERVED]

    def stats(self) -> dict:
        per_session = [s.stats() for s in self._snapshot()]
        return {
            "n_sessions": len(per_session),
            "max_sessions": self.max_sessions,
            "edges_accepted": sum(s["edges_accepted"] for s in per_session),
            "queries": sum(s["queries"] for s in per_session),
            "snapshots_mined": sum(s["snapshots_mined"] for s in per_session),
            "cache_hits": sum(s["cache"]["hits"] for s in per_session),
            "cache_misses": sum(s["cache"]["misses"] for s in per_session),
            "sessions": per_session,
        }

    # -- cross-tenant co-mining ---------------------------------------------

    def comine(self, graph, names: list[str] | None = None) -> dict:
        """Mine one graph under every selected tenant's config, co-scheduled.

        The tenants' :class:`~repro_torch.core.config.MiningConfig`\\ s are
        handed
        to ``PTMTEngine.discover_many``, which groups configs differing only
        in ``delta``/``l_max``/``omega`` into lattices and runs ONE shared
        Phase-1 sweep per lattice instead of one per tenant.  Counts are
        identical to per-tenant ``engine.discover`` calls.

        Returns ``{tenant_name: DiscoveryResult}``.  When every selected
        session was built from the same shared engine (the standard
        deployment), that engine runs the sweep; otherwise a
        manager-level engine is built lazily from the first tenant's
        config, on the device of that tenant's executor.

        A tenant dropped between auto-selection (``names=None``) and the
        mine is silently skipped — the registry moved on and the caller
        asked for "everyone current", not a fixed set.  Explicitly named
        tenants are a fixed set: a missing one raises ``KeyError``.
        """
        explicit = names is not None
        selected = list(names) if explicit else self.names()
        sessions, kept = [], []
        for n in selected:
            try:
                sessions.append(self.get(n))
            except KeyError:
                if explicit:
                    raise
                continue        # dropped mid-call under auto-selection
            kept.append(n)
        selected = kept
        if not sessions:
            return {}
        engines = {id(s.mining_engine): s.mining_engine
                   for s in sessions if s.mining_engine is not None}
        if len(engines) == 1:
            engine = next(iter(engines.values()))
        else:
            with self._lock:
                if self._comine_engine is None:
                    from repro_torch.core.engine import PTMTEngine

                    self._comine_engine = PTMTEngine(
                        sessions[0].config,
                        device=sessions[0].miner.executor.device)
                engine = self._comine_engine
        results = engine.discover_many(graph, [s.config for s in sessions])
        return dict(zip(selected, results))
