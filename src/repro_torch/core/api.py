"""Public PTMT API — result rendering.

The parameter surface lives in :class:`repro_torch.core.config.MiningConfig`
and the lifecycle in :class:`repro_torch.core.engine.PTMTEngine`::

    engine = PTMTEngine(MiningConfig(backend="cuda", delta=600, l_max=6))
    result = engine.discover(graph)
    baseline = engine.sequential(graph)
"""

from __future__ import annotations

import dataclasses

from . import transitions


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

