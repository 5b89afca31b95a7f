"""Unified mining configuration — ONE validated parameter surface.

Every discovery entry point (batch, sequential baseline, streaming,
serving sessions, the mesh path, and both CLIs) historically re-declared an
overlapping subset of ``delta / l_max / omega / e_cap / backend /
zone_chunk / agg / merge_cap / memory_budget_mb / allow_overflow`` and
re-validated (or forgot to validate) it independently.  :class:`MiningConfig`
is the single source of truth:

* **frozen + hashable** — a config is a value; it can key caches (the
  engine's compiled-plan cache, serving-session defaults) and be shared
  across threads without defensive copies;
* **validated on construction** — ``__post_init__`` runs :meth:`validate`,
  so an invalid config cannot exist; ``with_updates`` re-validates;
* **serializable** — ``to_json``/``from_json`` round-trip exactly, with
  the JAX package's fields and defaults, so a config JSON written by
  either package loads in the other (registry names differ: see
  :func:`repro_torch.core.convert.config_from_json`);
* **owns the CLI surface** — :meth:`add_cli_args` declares the shared
  mining flags once (defaults come from the dataclass fields, backend /
  agg choices from the live registries) and :meth:`from_cli_args` parses
  them back.

The device is not a config field: it is a constructor argument of
:class:`~repro_torch.core.engine.PTMTEngine` and
:class:`~repro_torch.core.executor.MiningExecutor`.

Precedence rule (the one genuine conflict in the surface): an explicit
``zone_chunk`` always beats a ``memory_budget_mb``-derived one — explicit
beats derived everywhere in this codebase — and setting both warns so the
silently-ignored budget is visible.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any

from . import backends
from .executor import AGG_MODES, FUSED_MODES
from .tzp import ZONE_LAYOUTS

__all__ = ["MiningConfig"]

#: argparse flag -> (help text,) for the shared mining surface; the flag
#: names are the dataclass field names with ``_`` -> ``-``.
_CLI_HELP = {
    "delta": "max gap between consecutive process steps (Definition 2)",
    "l_max": "max process length (Definition 4)",
    "omega": "growth-zone length in boundary units (Algorithm 1)",
    "e_cap": "per-zone edge capacity; denser zones are adaptively shrunk",
    "backend": "zone-scan backend",
    "zone_chunk": "process zones in chunks of this many to bound memory "
                  "(explicit value beats --memory-budget-mb)",
    "agg": "Phase-2 aggregation: hierarchical/pipelined bound peak memory "
           "to O(zone_chunk) instead of O(zones)",
    "merge_cap": "hierarchical bounded-merge carry width (default: derived)",
    "memory_budget_mb": "derive zone_chunk/merge_cap from this device "
                        "memory budget (core.planner) instead of hints",
    "allow_overflow": "mine even if the zone batch dropped edges beyond "
                      "e_cap (counts then undercount; default: error)",
    "zone_layout": "device zone-batch layout: 'bucketed' groups zones into "
                   "power-of-two e_cap buckets (less padding sweep work on "
                   "skewed zone sizes), 'dense' pads every zone to the "
                   "global max, 'auto' buckets only when sizes span more "
                   "than one bucket",
    "fused": "single-launch layout dispatch: 'auto' mines the whole layout "
             "in one bucket-native kernel launch (Phase-2 fold on-device) "
             "whenever the backend has a flat kernel, 'on' requires one, "
             "'off' keeps one launch per bucket",
    "fused_backend": "which backend's flat kernel serves fused runs: "
                     "'auto' keeps --backend except on a CPU device, where "
                     "the plain 'torch' scan takes over; an explicit name "
                     "pins it (must publish a fused scan)",
}


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    """The full PTMT parameter surface: paper params + execution params.

    Paper parameters (Definitions 2-5, Algorithm 1):
      delta, l_max, omega, e_cap — as in ``PTMTEngine.discover``.

    Execution parameters (see
    :class:`repro_torch.core.executor.MiningExecutor`):
      backend, zone_chunk, agg, merge_cap, memory_budget_mb,
      allow_overflow.

    Instances are frozen, hashable, and validated on construction.
    """

    delta: int = 600
    l_max: int = 6
    omega: int = 20
    e_cap: int | None = None
    backend: str = "ref"
    zone_chunk: int | None = None
    agg: str = "auto"
    merge_cap: int | None = None
    memory_budget_mb: float | None = None
    allow_overflow: bool = False
    zone_layout: str = "auto"
    fused: str = "auto"
    fused_backend: str = "auto"

    def __post_init__(self):
        # frozen dataclass: normalize via object.__setattr__ before the
        # value escapes, then validate — an invalid config never exists.
        # Non-integral values for integer fields are rejected, not
        # truncated: MiningConfig(delta=599.9) silently mining with
        # delta=599 would be a parameter the caller never asked for.
        for f in ("delta", "l_max", "omega", "e_cap", "zone_chunk",
                  "merge_cap"):
            val = getattr(self, f)
            if val is None:
                continue
            if int(val) != val:
                raise ValueError(
                    f"{f} must be an integer, got {val!r}")
            object.__setattr__(self, f, int(val))
        if self.memory_budget_mb is not None:
            object.__setattr__(self, "memory_budget_mb",
                               float(self.memory_budget_mb))
        object.__setattr__(self, "allow_overflow", bool(self.allow_overflow))
        self.validate()

    # -- validation ---------------------------------------------------------

    def validate(self) -> "MiningConfig":
        """Raise ``ValueError`` on any invalid field; returns self.

        Error messages keep the historical phrasings ("delta and l_max
        must be >= 1", "omega must be >= 2") that callers and tests match
        against.
        """
        if self.delta < 1 or self.l_max < 1:
            raise ValueError("delta and l_max must be >= 1")
        if self.omega < 2:
            raise ValueError(
                "omega must be >= 2 (growth zone >= 2 boundary zones)")
        if self.e_cap is not None and self.e_cap < 1:
            raise ValueError(f"e_cap must be >= 1, got {self.e_cap}")
        if self.zone_chunk is not None and self.zone_chunk < 0:
            raise ValueError(
                f"zone_chunk must be >= 0, got {self.zone_chunk}")
        if self.merge_cap is not None and self.merge_cap < 1:
            raise ValueError(
                f"merge_cap must be >= 1, got {self.merge_cap}")
        if self.memory_budget_mb is not None and self.memory_budget_mb <= 0:
            raise ValueError("memory_budget_mb must be > 0")
        if self.agg not in AGG_MODES:
            raise ValueError(
                f"unknown agg mode {self.agg!r}; one of {AGG_MODES}")
        if self.zone_layout not in ZONE_LAYOUTS:
            raise ValueError(
                f"unknown zone layout {self.zone_layout!r}; one of "
                f"{ZONE_LAYOUTS}")
        if self.fused not in FUSED_MODES:
            raise ValueError(
                f"unknown fused mode {self.fused!r}; one of {FUSED_MODES}")
        # resolves through the live registry so plugin backends validate
        # too; unknown names raise ValueError listing what is available
        backends.get_backend(self.backend)
        if self.fused_backend != "auto" and \
                not backends.get_backend(self.fused_backend).supports_fused:
            raise ValueError(
                f"fused_backend {self.fused_backend!r} has no fused "
                f"single-launch scan; pick one that publishes a flat "
                f"kernel (or leave it 'auto')")
        if self.zone_chunk is not None and self.memory_budget_mb is not None:
            # includes zone_chunk=0 ("explicitly unchunked") — any explicit
            # value beats the budget-derived chunk, so the budget is inert
            warnings.warn(
                f"both zone_chunk={self.zone_chunk} and memory_budget_mb="
                f"{self.memory_budget_mb} are set; the explicit zone_chunk "
                f"takes precedence and the budget-derived chunk is ignored",
                RuntimeWarning, stacklevel=3,
            )
        return self

    # -- derived ------------------------------------------------------------

    @property
    def l_b(self) -> int:
        """Boundary length ``delta * l_max`` (max process time span)."""
        return self.delta * self.l_max

    def with_updates(self, **updates: Any) -> "MiningConfig":
        """A new validated config with ``updates`` applied."""
        return dataclasses.replace(self, **updates)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, data: str | bytes | dict) -> "MiningConfig":
        """Inverse of :meth:`to_json`; also accepts an already-parsed dict.

        Unknown keys raise (a config round-trip must be exact, not lossy).
        """
        if not isinstance(data, dict):
            data = json.loads(data)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown MiningConfig field(s) {unknown}; known: "
                f"{sorted(known)}")
        return cls(**data)

    # -- CLI surface --------------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser) -> None:
        """Declare the shared mining flags on an argparse parser.

        Flag defaults are the dataclass field defaults and choice lists
        come from the live registries, so the CLIs can never drift from
        the config.  ``from_cli_args`` parses the result back.
        """
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        parser.add_argument("--delta", type=int, default=defaults["delta"],
                            help=_CLI_HELP["delta"])
        parser.add_argument("--l-max", type=int, default=defaults["l_max"],
                            help=_CLI_HELP["l_max"])
        parser.add_argument("--omega", type=int, default=defaults["omega"],
                            help=_CLI_HELP["omega"])
        parser.add_argument("--e-cap", type=int, default=defaults["e_cap"],
                            help=_CLI_HELP["e_cap"])
        parser.add_argument("--backend", default=defaults["backend"],
                            choices=list(backends.available_backends()),
                            help=_CLI_HELP["backend"])
        parser.add_argument("--zone-chunk", type=int,
                            default=defaults["zone_chunk"],
                            help=_CLI_HELP["zone_chunk"])
        parser.add_argument("--agg", default=defaults["agg"],
                            choices=list(AGG_MODES), help=_CLI_HELP["agg"])
        parser.add_argument("--merge-cap", type=int,
                            default=defaults["merge_cap"],
                            help=_CLI_HELP["merge_cap"])
        parser.add_argument("--memory-budget-mb", type=float,
                            default=defaults["memory_budget_mb"],
                            help=_CLI_HELP["memory_budget_mb"])
        parser.add_argument("--allow-overflow", action="store_true",
                            default=defaults["allow_overflow"],
                            help=_CLI_HELP["allow_overflow"])
        parser.add_argument("--zone-layout", default=defaults["zone_layout"],
                            choices=list(ZONE_LAYOUTS),
                            help=_CLI_HELP["zone_layout"])
        parser.add_argument("--fused", default=defaults["fused"],
                            choices=list(FUSED_MODES),
                            help=_CLI_HELP["fused"])
        parser.add_argument("--fused-backend",
                            default=defaults["fused_backend"],
                            choices=["auto",
                                     *backends.available_backends()],
                            help=_CLI_HELP["fused_backend"])

    @classmethod
    def from_cli_args(cls, args) -> "MiningConfig":
        """Build a validated config from a parsed argparse namespace."""
        return cls(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(cls)})
