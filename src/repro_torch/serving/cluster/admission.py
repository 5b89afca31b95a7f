"""Admission control — pending-edge budgets with an explicit throttle signal.

Ingest can outrun mining: admitted edges wait in per-session admission
windows (and, behind them, the miner's open-tail buffer) whose memory is
bounded only by arrival rate.  The controller enforces two budgets over the
*pending* (buffered, not yet flushed to the miner) edge count — one per
tenant, one global across the worker — and turns overflow into an explicit
**throttle decision** instead of unbounded buffering: the caller (the
replay harness, a transport) gets ``admitted=False`` with the binding
budget named, defers the chunk, and retries after draining.  Nothing is
dropped by the controller itself; shedding is a *caller* choice recorded
via :meth:`AdmissionController.shed`.

Deferred and shed volumes are exported through the ``obs`` registry
(``repro_cluster_deferred_edges_total`` / ``repro_cluster_shed_edges_total``,
labelled per tenant) so backpressure is visible in the same place as
latency and throughput.
"""

from __future__ import annotations

import dataclasses
import threading

from repro_torch.obs import get_obs


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of offering one edge chunk to the controller."""

    admitted: bool
    reason: str                # "ok" | "tenant_budget" | "global_budget"
    tenant_pending: int        # tenant's tracked pending AFTER this decision
    global_pending: int        # worker-wide pending AFTER this decision

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Tracks pending-edge debt per tenant and grants or defers chunks.

    ``offer(tenant, n)`` charges the chunk against both budgets and
    answers; callers must mirror reality back with :meth:`settle` after
    the ingest (the session reports its true ``pending_edges`` — flushes
    inside the ingest call repay debt immediately, so the controller
    never over-throttles on stale accounting).  A budget of ``None``
    disables that check.
    """

    def __init__(self, *, tenant_budget: int | None = 65536,
                 global_budget: int | None = None, obs=None):
        if tenant_budget is not None and tenant_budget < 1:
            raise ValueError("tenant_budget must be >= 1 (or None)")
        if global_budget is not None and global_budget < 1:
            raise ValueError("global_budget must be >= 1 (or None)")
        self.tenant_budget = tenant_budget
        self.global_budget = global_budget
        self.obs = get_obs(obs)
        self._lock = threading.Lock()
        self._pending: dict[str, int] = {}
        self._global = 0
        self.deferrals = 0
        self.deferred_edges = 0
        self.shed_edges = 0

    # -- decisions -----------------------------------------------------------

    def offer(self, tenant: str, n: int) -> AdmissionDecision:
        """Charge ``n`` arriving edges; admitted unless a budget binds."""
        n = int(n)
        with self._lock:
            tenant_pending = self._pending.get(tenant, 0)
            reason = "ok"
            if (self.tenant_budget is not None
                    and tenant_pending + n > self.tenant_budget):
                reason = "tenant_budget"
            elif (self.global_budget is not None
                    and self._global + n > self.global_budget):
                reason = "global_budget"
            if reason != "ok":
                self.deferrals += 1
                self.deferred_edges += n
                if self.obs.enabled:
                    self.obs.metrics.counter(
                        "repro_cluster_deferred_edges_total",
                        tenant=tenant, reason=reason).inc(n)
                return AdmissionDecision(False, reason, tenant_pending,
                                         self._global)
            self._pending[tenant] = tenant_pending + n
            self._global += n
            return AdmissionDecision(True, "ok", tenant_pending + n,
                                     self._global)

    def settle(self, tenant: str, pending: int) -> None:
        """Reconcile to the session's true pending count after an ingest."""
        pending = int(pending)
        with self._lock:
            old = self._pending.get(tenant, 0)
            self._pending[tenant] = pending
            self._global += pending - old

    def shed(self, tenant: str, n: int) -> None:
        """Record ``n`` edges the *caller* chose to drop under pressure."""
        n = int(n)
        with self._lock:
            self.shed_edges += n
        if self.obs.enabled:
            self.obs.metrics.counter(
                "repro_cluster_shed_edges_total", tenant=tenant).inc(n)

    def forget(self, tenant: str) -> None:
        """Release a tenant's debt (dropped or migrated away)."""
        with self._lock:
            self._global -= self._pending.pop(tenant, 0)

    # -- reporting -----------------------------------------------------------

    def pending(self, tenant: str | None = None) -> int:
        with self._lock:
            if tenant is None:
                return self._global
            return self._pending.get(tenant, 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenant_budget": self.tenant_budget,
                "global_budget": self.global_budget,
                "global_pending": self._global,
                "deferrals": self.deferrals,
                "deferred_edges": self.deferred_edges,
                "shed_edges": self.shed_edges,
                "pending": dict(self._pending),
            }
