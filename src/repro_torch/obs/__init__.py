"""Unified observability layer: metrics, spans, and timing helpers.

The mining stack (engine → executor → kernels → streaming → serving) emits
all its telemetry through ONE :class:`Observability` bundle — a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (counters / gauges /
histograms, exportable as JSON and Prometheus text) plus a
:class:`~repro_torch.obs.tracing.Tracer` (nested spans with device-accurate
timing and compile-vs-exec attribution, exportable as Chrome-trace JSON).

Opt-in by construction: the default everywhere is :data:`NULL_OBS`, whose
registry and tracer are shared no-op singletons, so instrumented code pays
a constant-time method call when observability is off.  Turn it on by
passing a live bundle where you build the stack::

    obs = repro_torch.obs.enabled()
    engine = PTMTEngine(config, obs=obs)
    engine.discover(graph)
    obs.metrics.snapshot()          # JSON dict
    obs.metrics.to_prometheus()     # scrape text
    obs.tracer.write("trace.json")  # open in chrome://tracing / Perfetto

or, from the CLIs, via ``--metrics-out``/``--trace-out`` on
``launch/mine.py`` and ``launch/serve_motifs.py``.

A process-global bundle (:func:`install_global` / :func:`global_obs`)
exists for layers with no construction-time injection point.  It defaults
to :data:`NULL_OBS` and the CLIs install their bundle into it.
"""

from __future__ import annotations

import dataclasses
import json

from . import metrics, timing, tracing
from .metrics import NULL_REGISTRY, MetricsRegistry, NullRegistry
from .tracing import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Observability",
    "NULL_OBS",
    "add_cli_args",
    "from_cli_args",
    "write_cli_outputs",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "enabled",
    "get_obs",
    "global_obs",
    "install_global",
    "metrics",
    "timing",
    "tracing",
]


@dataclasses.dataclass(frozen=True)
class Observability:
    """One bundle holding the registry + tracer a component emits into."""

    metrics: object = NULL_REGISTRY
    tracer: object = NULL_TRACER

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.metrics, "enabled", False)
                    or getattr(self.tracer, "enabled", False))

    @classmethod
    def enabled_bundle(cls) -> "Observability":
        """A fresh live registry + tracer."""
        return cls(metrics=MetricsRegistry(), tracer=Tracer())


def enabled() -> Observability:
    """Module-level convenience: ``obs = repro_torch.obs.enabled()``."""
    return Observability.enabled_bundle()


NULL_OBS = Observability()


def get_obs(obs: Observability | None) -> Observability:
    """Normalize an optional obs argument to a bundle (None → NULL_OBS)."""
    return obs if obs is not None else NULL_OBS


_GLOBAL: Observability = NULL_OBS


def install_global(obs: Observability | None) -> Observability:
    """Install the process-global bundle (None resets to NULL_OBS)."""
    global _GLOBAL
    _GLOBAL = get_obs(obs)
    return _GLOBAL


def global_obs() -> Observability:
    return _GLOBAL


# -- CLI plumbing (launch/mine.py and launch/serve_motifs.py) ----------------


def add_cli_args(ap) -> None:
    """Add the ``--metrics-out`` / ``--trace-out`` opt-in flags."""
    ap.add_argument(
        "--metrics-out", default=None, metavar="FILE",
        help="write a metrics snapshot (JSON with embedded Prometheus "
             "text) at exit; also enables metric collection")
    ap.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="write a Chrome-trace JSON (chrome://tracing / Perfetto) of "
             "all spans at exit; also enables span collection")


def from_cli_args(args) -> Observability:
    """Bundle from parsed flags: live (and installed as the process
    global) when either output was requested, else :data:`NULL_OBS`."""
    if getattr(args, "metrics_out", None) or getattr(args, "trace_out", None):
        return install_global(enabled())
    return NULL_OBS


def write_cli_outputs(obs: Observability, args) -> None:
    """Write the requested ``--metrics-out`` / ``--trace-out`` files."""
    path = getattr(args, "metrics_out", None)
    if path:
        with open(path, "w") as f:
            json.dump({"metrics": obs.metrics.snapshot(),
                       "prometheus": obs.metrics.to_prometheus()},
                      f, indent=1, sort_keys=True)
        print(f"metrics written to {path}")
    path = getattr(args, "trace_out", None)
    if path:
        obs.tracer.write(path)
        print(f"trace written to {path} "
              f"(load at https://ui.perfetto.dev or chrome://tracing)")
