"""PTMT session engine — one object that owns config + device state.

The paper's pipeline is one fixed lifecycle — plan zones (TZP), expand in
parallel, aggregate, encode.  :class:`PTMTEngine` is its single factory:

* ``engine.discover(graph)``    — batch PTMT discovery;
* ``engine.discover_many(graph, configs)`` — config-lattice co-mining:
  configs that differ only in ``delta``/``l_max``/``omega`` share one
  Phase-1 sweep;
* ``engine.sequential(graph)``  — the TMC-analog baseline (one zone, built
  through :func:`repro_torch.core.tzp.single_zone_plan` — no hand-rolled
  pad), on the engine's own backend;
* ``engine.stream()``           — a :class:`repro_torch.core.streaming.
  StreamingMiner` sharing this engine's executor (and so its device);
* ``engine.sharded(graph, mesh, axes)`` — the mesh path over a
  ``torch.distributed`` ``DeviceMesh``, with the SPMD mining step cached
  per ``(mesh, axes, out_cap, merge_mode)``;
* serving sessions take the engine whole: ``MotifSession(name,
  engine=engine)``.

The engine resolves the backend and the device **once** (at construction,
via the executor), owns the capacity planner (budget-derived plans are
memoized per batch geometry), and memoizes zone plans per graph
fingerprint, so repeated ``discover`` on the same stream skips
Algorithm 1.  ``engine.stats`` exposes the counters.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import get_obs

from . import planner, tzp
from .api import DiscoveryResult, counts_to_result
from .config import MiningConfig
from .executor import MiningExecutor
from .streaming import StreamingMiner
from .temporal_graph import TemporalGraph

__all__ = ["EngineStats", "PTMTEngine"]


@dataclasses.dataclass
class EngineStats:
    """Observable engine counters (mutated in place, cheap to read).

    When the engine is built with a live
    :class:`repro_torch.obs.Observability` bundle, the plan-cache counters
    are mirrored into the bundle's metrics registry."""

    discover_calls: int = 0
    discover_many_calls: int = 0    # co-mined multi-config discover calls
    comined_configs: int = 0        # member configs served by shared sweeps
    sequential_calls: int = 0
    sharded_calls: int = 0
    stream_sessions: int = 0
    plan_cache_hits: int = 0        # discover calls that skipped plan_zones
    plan_cache_misses: int = 0      # discover calls that ran Algorithm 1
    zones_mined: int = 0
    launches: int = 0               # scan dispatches (fused layout run = 1,
                                    # one per bucket otherwise)
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
        # lattice-keyed executor cache: dominating MiningConfig -> warm
        # MiningExecutor on this engine's device; the engine's own
        # executor serves a lattice whose dominating config IS the engine
        # config.  LRU-bounded like the zone-plan cache.
        self._lattice_executors: dict[MiningConfig, MiningExecutor] = {}
        self._lattice_executor_cap = 16
        # sharded mining steps (with their mesh), keyed (id(mesh), axes,
        # out_cap, merge_mode)
        self._mesh_steps: dict[tuple, object] = {}

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

    def capacity_plan(self, n_zones: int, e_cap: int):
        """Budget-derived capacity plan (None without a budget), memoized
        per batch geometry by the engine's executor."""
        return self.executor.capacity_plan(n_zones, e_cap)

    # -- batch discovery ----------------------------------------------------

    def plan_zones(self, graph: TemporalGraph,
                   config: MiningConfig | None = None) -> tzp.ZonePlan:
        """Zone plan for ``graph``, memoized by graph fingerprint.

        The cache key is ``(graph_fingerprint, delta, l_max, omega,
        e_cap)`` — exactly the inputs Algorithm 1 depends on — so repeated
        ``discover`` on the same stream skips host-side planning entirely.
        ``config`` plans for another config than the engine's (the
        co-mine path plans at a lattice's dominating config) through the
        same cache.
        """
        cfg = config or self.config
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

    def _plan_and_layout(self, graph: TemporalGraph, n_shards: int = 1, *,
                         config: MiningConfig | None = None,
                         executor: MiningExecutor | None = None):
        cfg = config or self.config
        executor = executor or self.executor
        plan = self.plan_zones(graph, config=cfg)
        pad_zones = (executor.zone_chunk or 1) * n_shards
        with self.obs.tracer.span("engine.layout", n_zones=plan.n_zones):
            layout = tzp.build_zone_layout(graph, plan,
                                           layout=cfg.zone_layout,
                                           e_cap=cfg.e_cap,
                                           pad_zones_to=pad_zones,
                                           n_shards=n_shards)
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

    # -- config-lattice co-mining --------------------------------------------

    def _lattice_executor(self, dominating: MiningConfig) -> MiningExecutor:
        """Warm executor for a lattice's dominating sweep config, on the
        engine's device."""
        if dominating == self.config:
            return self.executor
        ex = self._lattice_executors.get(dominating)
        if ex is not None:
            self._lattice_executors[dominating] = \
                self._lattice_executors.pop(dominating)   # LRU bump
            return ex
        ex = MiningExecutor.from_config(dominating, device=self.device,
                                        obs=self.obs)
        self._lattice_executors[dominating] = ex
        while len(self._lattice_executors) > self._lattice_executor_cap:
            self._lattice_executors.pop(next(iter(self._lattice_executors)))
        return ex

    def discover_many(self, graph: TemporalGraph,
                      configs) -> list[DiscoveryResult]:
        """Co-mine N configs from shared dominating Phase-1 sweeps.

        ``configs`` is a sequence of :class:`MiningConfig`s over the SAME
        graph.  Configs differing only in ``delta``/``l_max``/``omega``
        group into one lattice (:func:`repro_torch.core.planner.
        build_config_lattices`) and share ONE Phase-1 expansion planned at
        the dominating ``(max delta, max l_max, max omega)``; each
        member's count table is split out during the Phase-2 fold by
        prefix-truncating candidates on per-edge absorption timestamps.
        Results equal per-config :meth:`discover` calls byte for byte and
        come back in input order.
        """
        configs = list(configs)
        if not configs:
            return []
        self.stats.discover_many_calls += 1
        self.stats.comined_configs += len(configs)
        results: list[DiscoveryResult | None] = [None] * len(configs)
        lattices = planner.build_config_lattices(configs)
        with self.obs.tracer.span("engine.discover_many",
                                  n_edges=graph.n_edges,
                                  n_configs=len(configs),
                                  n_lattices=len(lattices)):
            for lat in lattices:
                self._discover_lattice(graph, lat, results)
        return results

    def _discover_lattice(self, graph: TemporalGraph,
                          lat: planner.ConfigLattice, results: list) -> None:
        """Mine one lattice's shared sweep and scatter member results."""
        dom = lat.dominating
        ex = self._lattice_executor(dom)
        plan, layout = self._plan_and_layout(graph, config=dom, executor=ex)
        counts_tuple, run_stats = ex.run_layout_multi(
            layout, lat.params, allow_overflow=dom.allow_overflow)
        if str(run_stats.get("path", "")).startswith("fused"):
            self.stats.fused_runs += 1
        self.stats.zones_mined += layout.n_zones
        self.stats.launches += int(run_stats.get("launches", 0))
        self._note_layout(layout)
        layout_summary = {**layout.summary(), "execution": dict(run_stats)}
        with self.obs.tracer.span("engine.decode", n_configs=lat.n_configs):
            for member, idx, counts in zip(lat.members, lat.indices,
                                           counts_tuple):
                results[idx] = counts_to_result(
                    counts, n_zones=plan.n_zones, e_cap=layout.e_cap,
                    overflow=layout.overflow, delta=member.delta,
                    l_max=member.l_max, layout=layout_summary,
                )

    def sequential(self, graph: TemporalGraph) -> DiscoveryResult:
        """TMC-analog baseline: one zone spanning the whole stream (no TZP).

        Always the dense layout (a single zone has nothing to bucket) —
        the one-zone batch goes through the same
        :func:`~repro_torch.core.tzp.build_zone_batch` padding policy as
        every other mode, and the backend's per-zone scan (on ``cuda``,
        one launch of the dense kernel over the whole stream).
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

    # -- streaming ----------------------------------------------------------

    def stream(self, **overrides) -> StreamingMiner:
        """A fresh :class:`StreamingMiner` bound to this engine's config.

        Without overrides the miner shares this engine's executor; with
        overrides a derived config (and executor) is built for the miner
        alone, on this engine's device.
        """
        self.stats.stream_sessions += 1
        if overrides:
            return StreamingMiner(config=self.config.with_updates(
                **overrides), device=self.device, obs=self.obs)
        return StreamingMiner(config=self.config, executor=self.executor,
                              obs=self.obs)

    # -- mesh path ----------------------------------------------------------

    def sharded(
        self,
        graph: TemporalGraph,
        mesh,
        axes: tuple[str, ...] | None = None,
        *,
        out_cap: int = 65536,
        merge_mode: str = "flat",
    ) -> DiscoveryResult:
        """Distributed discovery with zones sharded over ``mesh``, a
        ``DeviceMesh`` of the engine's device type; every rank of the mesh
        calls it on the same graph and gets the same result.

        The SPMD mining step is cached per ``(mesh, axes, out_cap,
        merge_mode)``, the mesh by identity; with a bucketed layout each bucket is sharded over
        the mesh independently (its zones were dealt round-robin across
        the shard lanes at build time) and the replicated per-bucket
        tables merge through the same bounded carry as the local path.
        Each bucket's run is a span whose execution key includes the
        step, so a first sharded run after a same-shaped ``discover``
        traces as a first run, not a repeat.
        """
        from repro_torch.distributed import mining as dist_mining

        self.stats.sharded_calls += 1
        axes = tuple(axes or mesh.mesh_dim_names)
        plan, layout = self._plan_and_layout(
            graph, n_shards=dist_mining.n_shards(mesh, axes))
        MiningExecutor.check_layout_overflow(
            layout, allow_overflow=self.config.allow_overflow)

        # keyed by the mesh object, kept beside its step so that its id
        # stays its own: an equal mesh of a later world has other groups
        step_key = (id(mesh), axes, out_cap, merge_mode)
        entry = self._mesh_steps.get(step_key)
        if entry is None:
            fn = dist_mining.make_mine_step(
                mesh, axes, executor=self.executor, out_cap=out_cap,
                merge_mode=merge_mode)
            entry = self._mesh_steps[step_key] = (mesh, fn)
        fn = entry[1]

        def traced(u, v, t, valid, signs):
            z, e = u.shape
            key = (step_key, self.executor.execution_key(z, e))
            with self.obs.tracer.span("mine.sharded", z=z, e=e,
                                      compile_key=key) as sp:
                out = fn(u, v, t, valid, signs)
                sp.sync(out[0])
            return out

        def note(bucket):
            self.stats.zones_mined += bucket.n_zones

        counts = dist_mining.run_mine_layout(
            traced, layout, out_cap=out_cap,
            merge_cap=self.executor.merge_cap, on_bucket=note)
        self._note_layout(layout)
        return counts_to_result(
            counts, n_zones=plan.n_zones, e_cap=layout.e_cap,
            overflow=layout.overflow, delta=self.config.delta,
            l_max=self.config.l_max, layout=layout.summary(),
        )
