"""Metrics registry — counters, gauges, and fixed-bucket histograms.

One process-wide (or per-run) :class:`MetricsRegistry` holds every
instrument the mining/serving stack emits.  Design constraints, in order:

* **thread-safe** — the serving layer increments from concurrent ingest and
  query threads; every instrument carries its own lock and the registry
  lock is held only for get-or-create, so tenants never contend on the hot
  paths;
* **exact tails below a bound** — histograms record raw samples up to
  ``sample_bound`` and compute p50/p95/p99 *exactly* from them; past the
  bound they degrade gracefully to fixed-bucket interpolation (the buckets
  are always maintained, so the Prometheus exposition never changes shape);
* **two export formats** — :meth:`MetricsRegistry.snapshot` (a plain JSON
  dict for ``--metrics-out`` files and ``BENCH_*.json`` payloads) and
  :meth:`MetricsRegistry.to_prometheus` (text exposition format 0.0.4, the
  scrape surface a real deployment would mount);
* **near-zero overhead when disabled** — :data:`NULL_REGISTRY` is a no-op
  singleton whose instruments are shared dummies; call sites never branch
  on "is observability on", they just talk to whatever registry they hold.

Naming convention: ``repro_mining_*`` for engine/executor/streaming,
``repro_serving_*`` for the motif service, ``repro_kernel_*`` for kernel
trace accounting.  Counters end in ``_total``; histogram values are
milliseconds unless the name says otherwise.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NullRegistry",
    "DEFAULT_MS_BUCKETS",
    "merged_percentile",
]

#: Default histogram buckets (milliseconds): spans sub-100µs kernel
#: dispatches up to multi-second cold compiles.
DEFAULT_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

#: Raw samples kept per histogram before percentiles fall back to bucket
#: interpolation.  Below this bound p50/p95/p99 are exact.
DEFAULT_SAMPLE_BOUND = 8192


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _format_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotone counter.  ``inc`` is atomic under the instrument lock.

    ``inc`` also takes a 0-dim tensor, a count the device computed: it is
    added to an accumulator on the tensor's device (one tensor op, no
    wait), and read back only when :attr:`value` is read (by
    :meth:`MetricsRegistry.snapshot` and :meth:`MetricsRegistry.
    to_prometheus`).  Such a count is not checked for sign, which would
    need the device's value on the host.
    """

    __slots__ = ("name", "labels", "_lock", "_value", "_acc")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0
        self._acc = None

    def inc(self, n=1) -> None:
        if hasattr(n, "add_"):
            self._inc_tensor(n)
            return
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    def _inc_tensor(self, n) -> None:
        import torch

        with self._lock, torch.no_grad():
            if self._acc is None:
                wide = torch.float64 if n.is_floating_point() else torch.int64
                self._acc = n.detach().to(wide, copy=True)
            else:
                self._acc.add_(n)

    @property
    def value(self):
        with self._lock:
            acc = self._acc
        return self._value if acc is None else self._value + acc.item()


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def add(self, delta) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with exact percentiles below a sample bound.

    Every ``observe`` updates the cumulative bucket counts, the running sum
    and count, and — up to ``sample_bound`` samples — a raw sample list.
    :meth:`percentile` is exact (nearest-rank on the sorted samples) while
    the sample list is complete; beyond the bound it interpolates linearly
    within the containing bucket, which is the standard Prometheus
    ``histogram_quantile`` estimate.
    """

    __slots__ = ("name", "labels", "buckets", "sample_bound", "_lock",
                 "_bucket_counts", "_count", "_sum", "_max", "_samples")

    def __init__(self, name: str, labels: dict,
                 buckets: tuple = DEFAULT_MS_BUCKETS,
                 sample_bound: int = DEFAULT_SAMPLE_BOUND):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(
                tuple(buckets)):
            raise ValueError("histogram buckets must be sorted and unique")
        self.name = name
        self.labels = dict(labels)
        self.buckets = tuple(float(b) for b in buckets)
        self.sample_bound = int(sample_bound)
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # + overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._samples: list[float] = []

    def observe(self, value) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._bucket_counts[idx] += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value
            if len(self._samples) < self.sample_bound:
                self._samples.append(value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def exact(self) -> bool:
        """True while every observation is still in the raw sample list."""
        return self._count <= self.sample_bound

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100): exact below the sample bound, bucket
        interpolation above it, 0.0 when empty."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            if self._count <= self.sample_bound:
                ordered = sorted(self._samples)
                # nearest-rank (ceil) — matches numpy's
                # method="inverted_cdf" and is exact for any sample set
                rank = max(int(-(-q * len(ordered) // 100)), 1)
                return ordered[rank - 1]
            target = q / 100.0 * self._count
            cum = 0
            for i, n in enumerate(self._bucket_counts):
                prev = cum
                cum += n
                if cum >= target:
                    lo = 0.0 if i == 0 else self.buckets[i - 1]
                    hi = self._max if i == len(self.buckets) \
                        else self.buckets[i]
                    frac = (target - prev) / n if n else 0.0
                    # clamp: an interpolated estimate must never exceed
                    # the largest value actually observed
                    return min(lo + (hi - lo) * frac, self._max)
            return self._max

    def samples(self) -> list[float]:
        """Copy of the raw sample list (complete only while :attr:`exact`)."""
        with self._lock:
            return list(self._samples)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._bucket_counts)
            count, total, mx = self._count, self._sum, self._max
        cum, cum_counts = 0, {}
        for edge, n in zip(self.buckets, counts):
            cum += n
            cum_counts[repr(edge)] = cum
        cum_counts["+Inf"] = count
        snap = {
            "count": count,
            "sum": total,
            "max": mx,
            "exact": count <= self.sample_bound,
            "buckets": cum_counts,
        }
        for q in (50, 95, 99):
            snap[f"p{q}"] = self.percentile(q)
        return snap


def merged_percentile(hists, q: float) -> float:
    """q-th percentile pooled across several histograms of one quantity
    (e.g. per-tenant latency histograms merged into a fleet-wide tail).

    Exact (nearest-rank over the pooled raw samples) while every input is
    still :attr:`Histogram.exact`; otherwise falls back to bucket
    interpolation over the summed cumulative counts, which requires every
    input to share the same bucket edges.  Empty inputs contribute nothing;
    an empty pool returns 0.0.
    """
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    hists = [h for h in hists if h is not None and h.count]
    if not hists:
        return 0.0
    if all(h.exact for h in hists):
        ordered = sorted(s for h in hists for s in h.samples())
        rank = max(int(-(-q * len(ordered) // 100)), 1)
        return ordered[rank - 1]
    edges = hists[0].buckets
    if any(h.buckets != edges for h in hists[1:]):
        raise ValueError("merged_percentile needs identical bucket edges")
    counts = [0] * (len(edges) + 1)
    total, mx = 0, 0.0
    for h in hists:
        with h._lock:
            for i, n in enumerate(h._bucket_counts):
                counts[i] += n
            total += h._count
            mx = max(mx, h._max)
    target = q / 100.0 * total
    cum = 0
    for i, n in enumerate(counts):
        prev = cum
        cum += n
        if cum >= target:
            lo = 0.0 if i == 0 else edges[i - 1]
            hi = mx if i == len(edges) else edges[i]
            frac = (target - prev) / n if n else 0.0
            return min(lo + (hi - lo) * frac, mx)
    return mx


class MetricsRegistry:
    """Get-or-create instrument registry with JSON + Prometheus export.

    ``registry.counter("repro_mining_launches_total", path="fused")``
    returns the one shared :class:`Counter` for that (name, labels) pair,
    creating it on first use.  Re-requesting an existing instrument with a
    different kind raises — a name means one thing.
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _get(self, kind, name: str, labels: dict, factory):
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = factory()
                    self._instruments[key] = inst
        if not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r}{labels!r} already registered as "
                f"{type(inst).__name__}, requested {kind.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels,
                         lambda: Counter(name, labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels, lambda: Gauge(name, labels))

    def histogram(self, name: str, *, buckets: tuple = DEFAULT_MS_BUCKETS,
                  sample_bound: int = DEFAULT_SAMPLE_BOUND,
                  **labels) -> Histogram:
        return self._get(
            Histogram, name, labels,
            lambda: Histogram(name, labels, buckets=buckets,
                              sample_bound=sample_bound))

    def find(self, name: str, **labels):
        """Already-registered instrument, or None (never creates)."""
        return self._instruments.get((name, _label_key(labels)))

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready dict: every instrument with labels and values."""
        counters, gauges, histograms = [], [], []
        for inst in self.instruments():
            entry = {"name": inst.name, "labels": dict(inst.labels)}
            if isinstance(inst, Counter):
                counters.append({**entry, "value": inst.value})
            elif isinstance(inst, Gauge):
                gauges.append({**entry, "value": inst.value})
            else:
                histograms.append({**entry, **inst.snapshot()})
        key = lambda e: (e["name"], sorted(e["labels"].items()))
        return {
            "counters": sorted(counters, key=key),
            "gauges": sorted(gauges, key=key),
            "histograms": sorted(histograms, key=key),
        }

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4 (one ``# TYPE`` header per name)."""
        by_name: dict[str, list] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = ("counter" if isinstance(group[0], Counter)
                    else "gauge" if isinstance(group[0], Gauge)
                    else "histogram")
            lines.append(f"# TYPE {name} {kind}")
            for inst in sorted(group, key=lambda i: sorted(i.labels.items())):
                if isinstance(inst, (Counter, Gauge)):
                    lines.append(
                        f"{name}{_format_labels(inst.labels)} {inst.value}")
                    continue
                snap = inst.snapshot()
                cum = 0
                with inst._lock:
                    counts = list(inst._bucket_counts)
                for edge, n in zip(inst.buckets, counts):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_format_labels(inst.labels, {'le': edge})} {cum}")
                lines.append(
                    f"{name}_bucket"
                    f"{_format_labels(inst.labels, {'le': '+Inf'})} "
                    f"{snap['count']}")
                lines.append(
                    f"{name}_sum{_format_labels(inst.labels)} {snap['sum']}")
                lines.append(
                    f"{name}_count{_format_labels(inst.labels)} "
                    f"{snap['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


class _NullCounter:
    __slots__ = ()
    name, labels, value = "", {}, 0

    def inc(self, n=1):
        pass


class _NullGauge:
    __slots__ = ()
    name, labels, value = "", {}, 0.0

    def set(self, value):
        pass

    def add(self, delta):
        pass


class _NullHistogram:
    __slots__ = ()
    name, labels = "", {}
    count, sum, exact = 0, 0.0, True

    def observe(self, value):
        pass

    def percentile(self, q):
        return 0.0

    def snapshot(self):
        return {"count": 0, "sum": 0.0, "max": 0.0, "exact": True,
                "buckets": {}, "p50": 0.0, "p95": 0.0, "p99": 0.0}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullRegistry:
    """No-op registry: shared dummy instruments, records nothing.

    The disabled-mode singleton (:data:`NULL_REGISTRY`).  Call sites hold
    a registry unconditionally; when observability is off every ``inc``/
    ``observe``/``set`` is a constant-time no-op on a shared object — no
    allocation, no locking, nothing to export.
    """

    enabled = False

    def counter(self, name, **labels):
        return _NULL_COUNTER

    def gauge(self, name, **labels):
        return _NULL_GAUGE

    def histogram(self, name, **kw):
        return _NULL_HISTOGRAM

    def find(self, name, **labels):
        return None

    def instruments(self):
        return []

    def snapshot(self):
        return {"counters": [], "gauges": [], "histograms": []}

    def to_prometheus(self):
        return ""


NULL_REGISTRY = NullRegistry()
