"""PTMT session engine — one object that owns config + device state.

The paper's pipeline is one fixed lifecycle — plan zones (TZP), expand in
parallel, aggregate, encode.  :class:`PTMTEngine` is its single factory:

* ``engine.discover(graph)``    — batch PTMT discovery;
* ``engine.sequential(graph)``  — the TMC-analog baseline (one zone, built
  through :func:`repro_torch.core.tzp.single_zone_plan` — no hand-rolled
  pad).

The engine resolves the backend and the device **once** (at construction,
via the executor) and memoizes zone plans per graph fingerprint, so
repeated ``discover`` on the same stream skips Algorithm 1.
``engine.stats`` exposes the counters.

Streaming, co-mining (``discover_many``) and sharded mining are later
slices of the port (ROADMAP).
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import get_obs

from . import tzp
from .api import DiscoveryResult, counts_to_result
from .config import MiningConfig
from .executor import MiningExecutor
from .temporal_graph import TemporalGraph

__all__ = ["EngineStats", "PTMTEngine"]


@dataclasses.dataclass
class EngineStats:
    """Observable engine counters (mutated in place, cheap to read).

    When the engine is built with a live
    :class:`repro_torch.obs.Observability` bundle, the plan-cache counters
    are mirrored into the bundle's metrics registry."""

    discover_calls: int = 0
    sequential_calls: int = 0
    plan_cache_hits: int = 0        # discover calls that skipped plan_zones
    plan_cache_misses: int = 0      # discover calls that ran Algorithm 1
    zones_mined: int = 0
    launches: int = 0               # scan dispatches (fused layout run = 1)
    fused_runs: int = 0             # discover calls served by the fused path
    padding_ratio: float = 0.0      # last layout's padded-slot waste
    bucket_occupancy: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PTMTEngine:
    """Session object for PTMT discovery: validated config + device.

    Construct from a :class:`~repro_torch.core.config.MiningConfig` (or
    field overrides — ``PTMTEngine(delta=600, l_max=6)`` builds one), then
    call any mode repeatedly.  The engine runs on CUDA unless ``device``
    says otherwise (``device="cpu"``); with no CUDA device and no explicit
    device, construction raises ``RuntimeError``.
    """

    def __init__(self, config: MiningConfig | None = None, *, device=None,
                 obs=None, **overrides):
        if config is None:
            config = MiningConfig(**overrides)
        elif overrides:
            config = config.with_updates(**overrides)
        self.config = config
        # obs is deliberately NOT a MiningConfig field: the config is a
        # frozen hashable value object, an Observability bundle is live
        # mutable state.  Neither is the device: a config JSON must load
        # the same on any host.
        self.obs = get_obs(obs)
        self.executor = MiningExecutor.from_config(config, device=device,
                                                   obs=self.obs)
        self.stats = EngineStats()
        # host-side zone-plan cache: (graph fingerprint, delta, l_max,
        # omega, e_cap) -> ZonePlan, LRU-bounded (plans hold O(n_zones)
        # arrays, and a long-lived engine must not grow without bound)
        self._zone_plans: dict[tuple, tzp.ZonePlan] = {}
        self._zone_plan_cap = 64

    @property
    def backend(self) -> str:
        return self.executor.backend

    @property
    def device(self):
        return self.executor.device

    def __repr__(self) -> str:
        return (f"PTMTEngine(backend={self.backend!r}, "
                f"device={str(self.device)!r}, delta={self.config.delta}, "
                f"l_max={self.config.l_max})")

    # -- batch discovery ----------------------------------------------------

    def plan_zones(self, graph: TemporalGraph) -> tzp.ZonePlan:
        """Zone plan for ``graph``, memoized by graph fingerprint.

        The cache key is ``(graph_fingerprint, delta, l_max, omega,
        e_cap)`` — exactly the inputs Algorithm 1 depends on — so repeated
        ``discover`` on the same stream skips host-side planning entirely.
        """
        cfg = self.config
        key = (tzp.graph_fingerprint(graph), cfg.delta, cfg.l_max,
               cfg.omega, cfg.e_cap)
        plan = self._zone_plans.get(key)
        if plan is not None:
            self.stats.plan_cache_hits += 1
            self.obs.metrics.counter(
                "repro_mining_plan_cache_hits_total").inc()
            self._zone_plans[key] = self._zone_plans.pop(key)  # LRU bump
            return plan
        with self.obs.tracer.span("engine.plan", n_edges=graph.n_edges):
            plan = tzp.plan_zones(graph, delta=cfg.delta, l_max=cfg.l_max,
                                  omega=cfg.omega, e_cap=cfg.e_cap)
        self._zone_plans[key] = plan
        while len(self._zone_plans) > self._zone_plan_cap:
            self._zone_plans.pop(next(iter(self._zone_plans)))
        self.stats.plan_cache_misses += 1
        self.obs.metrics.counter("repro_mining_plan_cache_misses_total").inc()
        return plan

    def _plan_and_layout(self, graph: TemporalGraph):
        cfg = self.config
        plan = self.plan_zones(graph)
        pad_zones = self.executor.zone_chunk or 1
        with self.obs.tracer.span("engine.layout", n_zones=plan.n_zones):
            layout = tzp.build_zone_layout(graph, plan,
                                           layout=cfg.zone_layout,
                                           e_cap=cfg.e_cap,
                                           pad_zones_to=pad_zones)
        return plan, layout

    def _note_layout(self, layout: tzp.ZoneBatchLayout) -> None:
        self.stats.padding_ratio = layout.padding_ratio
        self.stats.bucket_occupancy = {
            b.label or "dense": b.occupancy for b in layout.buckets}

    def discover(self, graph: TemporalGraph) -> DiscoveryResult:
        """PTMT parallel discovery (plan zones → expand → aggregate).

        The zone batch is laid out per ``config.zone_layout`` (size
        buckets by default when zone sizes are skewed) and mined by the
        executor's layout path; repeated calls on the same graph skip
        planning (``stats.plan_cache_hits``).
        """
        self.stats.discover_calls += 1
        with self.obs.tracer.span("engine.discover",
                                  n_edges=graph.n_edges) as sp:
            plan, layout = self._plan_and_layout(graph)
            counts, run_stats = self.executor.run_layout(
                layout, allow_overflow=self.config.allow_overflow)
            sp.set(n_zones=plan.n_zones, path=run_stats.get("path"))
            with self.obs.tracer.span("engine.decode"):
                result = counts_to_result(
                    counts, n_zones=plan.n_zones, e_cap=layout.e_cap,
                    overflow=layout.overflow, delta=self.config.delta,
                    l_max=self.config.l_max,
                    layout={**layout.summary(),
                            "execution": dict(run_stats)},
                )
        if str(run_stats.get("path", "")).startswith("fused"):
            self.stats.fused_runs += 1
        self.stats.zones_mined += layout.n_zones
        self.stats.launches += int(run_stats.get("launches", 0))
        self._note_layout(layout)
        return result

    def sequential(self, graph: TemporalGraph) -> DiscoveryResult:
        """TMC-analog baseline: one zone spanning the whole stream (no TZP).

        Always the dense layout (a single zone has nothing to bucket) —
        the one-zone batch goes through the same
        :func:`~repro_torch.core.tzp.build_zone_batch` padding policy as
        every other mode, and the backend's per-zone scan.
        """
        self.stats.sequential_calls += 1
        plan = tzp.single_zone_plan(graph, l_b=self.config.l_b)
        layout = tzp.build_zone_layout(graph, plan, layout="dense")
        batch = layout.buckets[0]
        counts = self.executor.run(batch)
        self.stats.zones_mined += batch.n_zones
        return counts_to_result(
            counts, n_zones=1, e_cap=batch.e_cap, overflow=batch.overflow,
            delta=self.config.delta, l_max=self.config.l_max,
            layout=layout.summary(),
        )
