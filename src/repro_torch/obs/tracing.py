"""Structured spans with device-accurate timing and compile attribution.

CUDA dispatch is asynchronous: a torch op on a CUDA tensor returns as soon
as its kernel is *enqueued*, so a naive ``perf_counter`` pair around it
times the Python dispatch, not the device execution — and the first call
of a kernel also pays its build.  :class:`Tracer` fixes both:

* a span can carry a **sync target** (``sp.sync(out)``): at span exit the
  tracer calls ``torch.cuda.synchronize()`` when the value holds a CUDA
  tensor, *before* taking the end timestamp, so the recorded duration
  covers actual device execution;
* a span can instead carry a **device** (``tracer.span(name, device=d)``):
  on a CUDA device it records a timing event on the device's current
  stream at enter and at exit, and never waits.  The pair becomes the
  span's **device interval**, put on the host's ``perf_counter`` clock
  through one anchor (a synchronize, a host timestamp and an event, taken
  when the device is first named) and a second one taken at read time,
  which corrects the rate of the device's clock.  As spans close, the
  oldest pairs whose work has completed become offsets and their events
  are reused, without a wait; the rest are waited for when the spans are
  read (:meth:`Tracer.intervals`, :meth:`Tracer.to_chrome_trace`).  Both
  events go on the stream that was current when the span opened.  Spans
  on the CPU have no device interval;
* a span can carry a **compile key** (the executor's execution key): the
  first span observed for a key is attributed ``phase="compile"`` (its
  duration includes first-use set-up), every later span for the same
  key is ``phase="exec"`` (steady state).  :meth:`Tracer.attribution`
  aggregates ``compile_ms`` vs ``exec_ms`` per key.

Spans nest: each thread keeps a stack of open spans, and every event
records its ``id``, its enclosing span's (``parent``) and the outermost
open span's (``root``, shared by all spans of one call) in its ``args``.
:meth:`Tracer.to_chrome_trace` emits the Chrome tracing / Perfetto JSON
format, the device intervals as one more track per device on the same
``ts`` clock — load the ``--trace-out`` file at ``chrome://tracing`` or
https://ui.perfetto.dev directly.

:data:`NULL_TRACER` is the disabled-mode singleton: ``span()`` returns one
shared no-op context manager, so an instrumented hot path costs a single
dict-free method call when tracing is off.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "NULL_TRACER", "NullTracer"]

#: chrome-trace thread id of device ``i``'s track (host threads keep theirs)
DEVICE_TID_BASE = 1 << 30

#: pending device intervals at which a closing span resolves those whose
#: work has completed (a query per pair, never a wait)
RESOLVE_EVERY = 64


def _holds_cuda(value) -> bool:
    """Whether ``value`` (a tensor or a nest of containers) holds a CUDA
    tensor — host values need no device wait."""
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    return bool(getattr(value, "is_cuda", False))


class DeviceClock:
    """CUDA timing events of one device, placed on ``time.perf_counter``.

    Made when a tracer first needs the device: it synchronizes once and
    records the anchor event at a known host time.  :meth:`mark` records
    an event on a stream and returns at once; events come from a pool and
    go back to it once resolved, so a long run creates few.  A pair is
    resolved once its work has completed (:meth:`done` asks without
    waiting), its start measured from the newest resolved start, so that
    the offsets keep microsecond precision however long the run.  The
    offsets map onto the host clock at read time, through the anchor and
    a second anchor that corrects the rate of the device's clock against
    the host's (:meth:`calibrate`, which synchronizes)."""

    def __init__(self, device):
        import torch

        self._cuda = torch.cuda
        self.device = device
        self.name = str(device)
        self._pool: list = []
        self.host0, event = self._anchor()
        self._ref = (0.0, event)     # (ms after the anchor, its event)
        self._scale = 1.0

    def _anchor(self):
        cuda = self._cuda
        cuda.synchronize(self.device)
        event = cuda.Event(enable_timing=True)
        a = time.perf_counter()
        event.record(cuda.current_stream(self.device))
        b = time.perf_counter()
        event.synchronize()
        return (a + b) / 2, event

    def stream(self):
        """The device's current stream, which a span's events go on."""
        return self._cuda.current_stream(self.device)

    def mark(self, stream):
        try:
            event = self._pool.pop()
        except IndexError:
            event = self._cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    @staticmethod
    def done(end) -> bool:
        return end.query()

    def resolve(self, start, end) -> tuple[float, float]:
        """``(start_ms, end_ms)`` after the anchor of a pair, waiting for
        its work to complete; both events go back to the pool."""
        end.synchronize()
        ref_ms, ref = self._ref
        a = ref_ms + ref.elapsed_time(start)
        b = a + start.elapsed_time(end)
        if a > ref_ms:
            self._ref = (a, start)
            start = ref
        self._pool += (start, end)
        return a, b

    def calibrate(self) -> None:
        host, event = self._anchor()
        ref_ms, ref = self._ref
        device_s = (ref_ms + ref.elapsed_time(event)) / 1e3
        if device_s > 1.0:         # shorter spans measure the rate poorly
            self._scale = (host - self.host0) / device_s

    def host_s(self, ms: float) -> float:
        return self.host0 + ms / 1e3 * self._scale


class Span:
    """One in-flight span; use as a context manager (``with tracer.span(...)
    as sp``).  Mutate via :meth:`set` (attach attributes) and :meth:`sync`
    (wait for the device before the end timestamp)."""

    __slots__ = ("name", "args", "_tracer", "_compile_key", "_sync",
                 "_t0", "_ids", "_clock", "_stream", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, compile_key, args: dict,
                 clock: DeviceClock | None = None):
        self.name = name
        self.args = args
        self._tracer = tracer
        self._compile_key = compile_key
        self._sync = None
        self._t0 = 0.0
        self._ids = (0, None, 0)    # (id, parent, root)
        self._clock = clock
        self._stream = None
        self._ev0 = None

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def sync(self, value) -> "Span":
        """Wait for ``value`` (a tensor, or tuples/lists/dicts/NamedTuples
        of them) at span exit, before the end timestamp — makes the
        duration device-accurate."""
        self._sync = value
        return self

    def __enter__(self) -> "Span":
        self._ids = self._tracer._enter()
        self._t0 = time.perf_counter()
        if self._clock is not None:
            self._stream = self._clock.stream()
            self._ev0 = self._clock.mark(self._stream)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._sync is not None and _holds_cuda(self._sync):
            import torch

            torch.cuda.synchronize()
        ev1 = (self._clock.mark(self._stream) if self._clock is not None
               else None)
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._finish(self, self._t0, t1, ev1)
        return False


class Tracer:
    """Collects finished spans; exports Chrome-trace JSON + attribution.

    Thread-safe: spans may open/close concurrently on any thread (each
    event records its thread id, and per-thread stacks of open spans keep
    nesting local).  The buffer is bounded (``max_events``, a span's
    device interval counting as one more) so a runaway loop cannot
    exhaust memory — overflow increments :attr:`dropped` instead.
    """

    enabled = True

    def __init__(self, max_events: int = 200_000):
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._seen_keys: set = set()
        self._attribution: dict = {}
        self._local = threading.local()
        self._origin = time.perf_counter()
        self._ids = itertools.count(1)
        self._clocks: dict = {}
        # device intervals: their events until their work has completed,
        # then offsets after their clock's anchor
        self._pending: collections.deque = collections.deque()
        self._device: list[tuple] = []

    def span(self, name: str, *, compile_key=None, device=None,
             **args) -> Span:
        """A span; ``device`` (a CUDA device) gives it a device interval."""
        clock = self._clock(device) if device is not None else None
        return Span(self, name, compile_key, args, clock)

    def _clock(self, device) -> DeviceClock | None:
        try:
            return self._clocks[device]
        except KeyError:
            pass
        import torch

        dev = torch.device(device)
        clock = None
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            clock = next((c for c in self._clocks.values()
                          if c is not None and c.device == dev), None)
            if clock is None:
                clock = DeviceClock(dev)
        self._clocks[device] = clock
        return clock

    # -- span plumbing ------------------------------------------------------

    def _enter(self) -> tuple:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        span_id = next(self._ids)
        ids = (span_id, stack[-1] if stack else None,
               stack[0] if stack else span_id)
        stack.append(span_id)
        return ids

    def _finish(self, span: Span, t0: float, t1: float, ev1=None) -> None:
        span_id, parent, root = span._ids
        stack = self._local.stack
        if stack and stack[-1] == span_id:
            stack.pop()
        elif span_id in stack:
            stack.remove(span_id)
        dur_ms = (t1 - t0) * 1e3
        phase = None
        if span._compile_key is not None:
            key = span._compile_key
            with self._lock:
                if key in self._seen_keys:
                    phase = "exec"
                    att = self._attribution[key]
                    att["exec_calls"] += 1
                    att["exec_ms_total"] += dur_ms
                    att["exec_ms_min"] = min(att["exec_ms_min"], dur_ms)
                else:
                    phase = "compile"
                    self._seen_keys.add(key)
                    self._attribution[key] = {
                        "span": span.name,
                        "compile_ms": dur_ms,
                        "exec_calls": 0,
                        "exec_ms_total": 0.0,
                        "exec_ms_min": float("inf"),
                    }
        args = span.args
        if phase is not None:
            args["phase"] = phase
        args["id"], args["parent"], args["root"] = span_id, parent, root
        event = {
            "name": span.name,
            "cat": "repro",
            "ph": "X",
            "ts": (t0 - self._origin) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            held = (len(self._events) + len(self._device)
                    + len(self._pending))
            if held + (ev1 is not None) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)
            if ev1 is None:
                return
            self._pending.append((span.name, span_id, parent, root,
                                  span._clock, span._ev0, ev1))
            if len(self._pending) >= RESOLVE_EVERY:
                self._resolve(wait=False)

    def _resolve(self, *, wait: bool) -> None:
        """Turn pending device intervals into offsets, oldest first (the
        lock is held).  Without ``wait`` it stops at the first whose work
        has not completed."""
        pending = self._pending
        while pending:
            name, span_id, parent, root, clock, ev0, ev1 = pending[0]
            if not wait and not clock.done(ev1):
                return
            pending.popleft()
            a, b = clock.resolve(ev0, ev1)
            self._device.append((name, span_id, parent, root, clock.name,
                                 a, b))

    # -- introspection / export --------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> set[str]:
        with self._lock:
            return {e["name"] for e in self._events}

    def device_events(self) -> list[dict]:
        """Every span's device interval: ``name``, ``id``, ``parent``,
        ``root``, ``device`` and ``start``/``end`` in ``perf_counter``
        seconds.  Waits for the device (read time only)."""
        with self._lock:
            self._resolve(wait=True)
            clocks = {c.name: c for c in self._clocks.values()
                      if c is not None}
            for clock in clocks.values():
                clock.calibrate()
            return [{"name": name, "id": span_id, "parent": parent,
                     "root": root, "device": dev,
                     "start": clocks[dev].host_s(a),
                     "end": clocks[dev].host_s(b)}
                    for name, span_id, parent, root, dev, a, b
                    in self._device]

    def intervals(self) -> tuple[list, list]:
        """``(host, device)``: every span as ``(name, start, end)`` in
        absolute ``perf_counter`` seconds, on the host and on the device
        (spans without a device interval appear in ``host`` only)."""
        host = [(e["name"], self._origin + e["ts"] / 1e6,
                 self._origin + (e["ts"] + e["dur"]) / 1e6)
                for e in self.events()]
        device = [(d["name"], d["start"], d["end"])
                  for d in self.device_events()]
        return host, device

    def attribution(self) -> dict:
        """``{compile_key: {compile_ms, exec_calls, exec_ms_total, ...}}``.

        ``compile_ms`` is the first-call duration (trace + compile + one
        run); ``exec_ms_min`` is the best steady-state execution — their
        ratio is the compile overhead a warm cache amortizes away.
        """
        with self._lock:
            out = {}
            for key, att in self._attribution.items():
                row = dict(att)
                if row["exec_ms_min"] == float("inf"):
                    row["exec_ms_min"] = None
                out[repr(key)] = row
            return out

    def to_chrome_trace(self) -> dict:
        """Chrome tracing JSON object format (Perfetto-loadable): the host
        spans on their threads, the device intervals on one track per
        device (``tid`` :data:`DEVICE_TID_BASE` + its index), on the same
        ``ts`` clock."""
        pid = os.getpid()
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": "repro-ptmt"},
        }]
        device = []
        for d in self.device_events():
            tid = DEVICE_TID_BASE + (int(d["device"].partition(":")[2])
                                     if ":" in d["device"] else 0)
            if not any(m.get("tid") == tid for m in meta):
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid,
                             "args": {"name": f"{d['device']} stream"}})
            device.append({
                "name": d["name"],
                "cat": "repro.device",
                "ph": "X",
                "ts": (d["start"] - self._origin) * 1e6,
                "dur": (d["end"] - d["start"]) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {"id": d["id"], "parent": d["parent"],
                         "root": d["root"], "device": d["device"]},
            })
        return {
            "traceEvents": meta + self.events() + device,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": self.dropped,
                "attribution": self.attribution(),
            },
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


class _NullSpan:
    __slots__ = ()
    name, args = "", {}

    def set(self, **attrs):
        return self

    def sync(self, value):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled-mode tracer: every ``span()`` is the same shared no-op."""

    enabled = False
    dropped = 0

    def span(self, name, *, compile_key=None, device=None, **args):
        return _NULL_SPAN

    def events(self):
        return []

    def device_events(self):
        return []

    def intervals(self):
        return [], []

    def span_names(self):
        return set()

    def attribution(self):
        return {}

    def to_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}

    def write(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


NULL_TRACER = NullTracer()
