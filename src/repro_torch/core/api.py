"""Public PTMT API — result rendering.

The parameter surface lives in :class:`repro_torch.core.config.MiningConfig`
and the lifecycle in :class:`repro_torch.core.engine.PTMTEngine`::

    engine = PTMTEngine(MiningConfig(backend="cuda", delta=600, l_max=6))
    result = engine.discover(graph)
    baseline = engine.sequential(graph)

The JAX package's one-shot ``discover`` / ``discover_sequential`` kwargs
functions were removed there after a deprecation cycle; the names remain
importable here too but raise immediately with a pointer at the engine
API, so a stale call site fails with instructions instead of an
``ImportError``.
"""

from __future__ import annotations

import dataclasses

from . import transitions

_REMOVED = (
    "repro_torch.core.{name}(...) was removed; build a PTMTEngine from a "
    "MiningConfig — PTMTEngine(MiningConfig(delta=..., l_max=...))"
    ".{method}(graph) — which keeps its zone-plan cache and built kernels "
    "across calls.  Mesh-sharded mining is "
    "engine.sharded(graph, mesh, axes)."
)


@dataclasses.dataclass
class DiscoveryResult:
    counts: dict[str, int]          # final-code string -> exact count
    n_zones: int
    e_cap: int
    overflow: int                   # edges dropped by zone capacity (0 = exact)
    delta: int
    l_max: int
    #: device zone-batch layout summary (``ZoneBatchLayout.summary()``):
    #: kind, padding_ratio, per-bucket occupancy.  None for paths that do
    #: not build a layout (e.g. streaming snapshots' merged totals).
    layout: dict | None = None

    def tree(self) -> transitions.TransitionTree:
        return transitions.build_tree(self.counts)

    def total_processes(self) -> int:
        return sum(self.counts.values())

    def level_histogram(self) -> dict[int, int]:
        return transitions.level_histogram(self.counts)


def counts_to_result(counts, *, n_zones, e_cap, overflow, delta,
                     l_max, layout=None) -> DiscoveryResult:
    """Render a device :class:`CodeCounts` into a :class:`DiscoveryResult`."""
    count_dict = transitions.device_counts_to_dict(counts)
    return DiscoveryResult(
        counts=count_dict, n_zones=n_zones, e_cap=e_cap, overflow=overflow,
        delta=delta, l_max=l_max, layout=layout,
    )


def discover(*args, **kwargs):
    """REMOVED — use :meth:`repro_torch.core.engine.PTMTEngine.discover`."""
    raise RuntimeError(_REMOVED.format(name="discover", method="discover"))


def discover_sequential(*args, **kwargs):
    """REMOVED — use :meth:`repro_torch.core.engine.PTMTEngine.sequential`."""
    raise RuntimeError(
        _REMOVED.format(name="discover_sequential", method="sequential"))
