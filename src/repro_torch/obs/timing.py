"""Shared wall-clock timing helpers — ONE copy of the percentile math.

Before this module, three call sites hand-rolled the same latency
bookkeeping: ``core/streaming.replay_stream`` built per-chunk latency lists
with raw ``perf_counter`` pairs, ``launch/serve_motifs.percentile_ms`` did
its own p50/p99 conversion, and ``launch/dryrun`` timed compiles with a
third inline pattern.  They all route through here now, so "p99" means the
same computation everywhere it is printed or exported.

These helpers are for *host wall-clock* measurement (stream replay,
compile timing).  Device-accurate span timing lives in
:mod:`repro_torch.obs.tracing`; streaming percentile state lives in
:class:`repro_torch.obs.metrics.Histogram`.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["Stopwatch", "percentile_ms", "latency_summary"]


class Stopwatch:
    """Context-manager timer: ``with Stopwatch() as sw: ...; sw.seconds``.

    Reading :attr:`seconds` inside the block returns the running elapsed
    time; after exit it is frozen at the block's duration.
    """

    __slots__ = ("_t0", "_elapsed")

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._elapsed = time.perf_counter() - self._t0
        self._t0 = None
        return False

    @property
    def seconds(self) -> float:
        if self._t0 is not None:
            return time.perf_counter() - self._t0
        return self._elapsed

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


def percentile_ms(latencies_s, q: float) -> float:
    """q-th percentile of a list of second-valued latencies, in ms.

    Empty input returns 0.0 — a report row for an op that never ran prints
    zeros rather than raising.
    """
    lat = np.asarray(list(latencies_s), dtype=np.float64)
    if lat.size == 0:
        return 0.0
    return float(np.percentile(lat, q) * 1e3)


def latency_summary(latencies_s) -> dict:
    """Standard latency digest (count / mean / p50 / p95 / p99 / max, ms)."""
    lat = np.asarray(list(latencies_s), dtype=np.float64)
    if lat.size == 0:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0}
    return {
        "count": int(lat.size),
        "mean_ms": float(lat.mean() * 1e3),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "max_ms": float(lat.max() * 1e3),
    }
