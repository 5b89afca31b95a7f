"""The traced run's record: device activity from ``torch.profiler``, host
spans, and what the per-layer readers take from them.

Device activities come from the profiler's CUDA trace (kernels, copies,
memsets).  Their clock is aligned with the host's ``time.perf_counter``
by a marker: after a synchronize, the marker kernel is the first device
activity, launched at a known host time.  Host spans are the program's
own (``repro_torch.obs`` tracer events) and the benchmark's (one per
call); both are on ``perf_counter`` already.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

#: device operations and idle labels kept in the result's breakdown
BREAKDOWN_TOP = 10


@dataclasses.dataclass
class Record:
    """Everything a per-layer reader may read about one traced window."""

    t0: float                      # window start, perf_counter seconds
    t1: float                      # window end (the last call's end)
    calls: int                     # calls completed in the window
    work: float                    # work units completed in the window
    spans: list                    # (name, start, end): host spans
    device: list                   # (name, start, end): device activities
    context: dict                  # the entry's counts (roofline work...)
    setup_s: float | None = None   # process start to the window's start
    _starts: list | None = dataclasses.field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self, intervals):
        for name, a, b in intervals:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                yield name, a, b

    def rate(self) -> float | None:
        """Work units completed per second of the whole window."""
        return self.work / self.window_s if self.calls else None

    def span_s(self, *names) -> float | None:
        """Seconds inside host spans of these names in the window; None
        when no such span was recorded."""
        hits = [b - a for n, a, b in self.in_window(self.spans)
                if n in names]
        return sum(hits) if hits else None

    def device_s(self, match) -> float:
        """Device seconds of the activities whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.in_window(self.device)
                   if match(n))

    def busy_intervals(self) -> list:
        merged: list = []
        for _, a, b in sorted(self.in_window(self.device),
                              key=lambda r: r[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_pct(self) -> float | None:
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def per_call_ms(self, seconds: float | None) -> float | None:
        if seconds is None or not self.calls:
            return None
        return 1e3 * seconds / self.calls

    def roofline_pct(self, work: dict | None, match) -> float | None:
        """Share of the least time of ``work`` (one call's) in the device
        time per call of the activities ``match`` accepts."""
        from ptmt_bench.roofline import zone_scan

        kernel_s = self.device_s(match)
        if work is None or kernel_s <= 0 or not self.calls:
            return None
        return 100.0 * zone_scan.bound_s(work) / (kernel_s / self.calls)

    def idle_gaps(self) -> list:
        """``(start, end)`` of every stretch of the window with no device
        activity."""
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def host_label(self, at: float) -> str:
        """The innermost host span open at ``at`` (spans nest or are
        disjoint, so it is the open span that started last)."""
        if self._starts is None:
            self._sorted = sorted(self.spans, key=lambda r: r[1])
            self._starts = [a for _, a, _ in self._sorted]
        i = bisect.bisect_right(self._starts, at) - 1
        while i >= 0:
            name, a, b = self._sorted[i]
            if b >= at:
                return name
            i -= 1
        return "between calls"

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for n, a, b in self.in_window(self.device):
            ops[n] = ops.get(n, 0.0) + (b - a)
        idle: dict[str, float] = {}
        for a, b in self.idle_gaps():
            label = self.host_label((a + b) / 2)
            idle[label] = idle.get(label, 0.0) + (b - a)
        top = lambda d: [[k[:200], v] for k, v in sorted(
            d.items(), key=lambda r: -r[1])[:BREAKDOWN_TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activities only."""

    def __init__(self, device):
        self.device = device
        self.events: list = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        raw = self._device_events()
        if not raw:
            raise RuntimeError("the profiler recorded no device activity")
        marker = next((r for r in raw if "spin" in r[0].lower()),
                      min(raw, key=lambda r: r[1]))
        offset = self._marker_host - marker[1]
        self.events = [(n, a + offset, b + offset)
                       for n, a, b in (r for r in raw if r is not marker)]
        return False

    def _device_events(self) -> list:
        """``(name, start, end)`` in seconds of the profiler's clock, read
        from the profiler's raw results (building its Python event tree
        takes minutes for a window of some 10^5 kernels)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        return [(e.name(), e.start_ns() / 1e9,
                 (e.start_ns() + e.duration_ns()) / 1e9)
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == cuda]
