"""Structured spans with device-accurate timing and compile attribution.

CUDA dispatch is asynchronous: a torch op on a CUDA tensor returns as soon
as its kernel is *enqueued*, so a naive ``perf_counter`` pair around it
times the Python dispatch, not the device execution — and the first call
of a kernel also pays its build.  :class:`Tracer` fixes both:

* a span can carry a **sync target** (``sp.sync(out)``): at span exit the
  tracer calls ``torch.cuda.synchronize()`` when the value holds a CUDA
  tensor, *before* taking the end timestamp, so the recorded duration
  covers actual device execution;
* a span can carry a **compile key** (the executor's execution key): the
  first span observed for a key is attributed ``phase="compile"`` (its
  duration includes first-use set-up), every later span for the same
  key is ``phase="exec"`` (steady state).  :meth:`Tracer.attribution`
  aggregates ``compile_ms`` vs ``exec_ms`` per key.

Spans nest: each thread keeps a depth counter, so the exported events
reconstruct the call tree (Chrome's trace viewer nests complete events on
one thread by time containment).  :meth:`Tracer.to_chrome_trace` emits the
Chrome tracing / Perfetto JSON format — load the ``--trace-out`` file at
``chrome://tracing`` or https://ui.perfetto.dev directly.

:data:`NULL_TRACER` is the disabled-mode singleton: ``span()`` returns one
shared no-op context manager, so an instrumented hot path costs a single
dict-free method call when tracing is off.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "NULL_TRACER", "NullTracer"]


def _holds_cuda(value) -> bool:
    """Whether ``value`` (a tensor or a nest of containers) holds a CUDA
    tensor — host values need no device wait."""
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    return bool(getattr(value, "is_cuda", False))


class Span:
    """One in-flight span; use as a context manager (``with tracer.span(...)
    as sp``).  Mutate via :meth:`set` (attach attributes) and :meth:`sync`
    (wait for the device before the end timestamp)."""

    __slots__ = ("name", "args", "_tracer", "_compile_key", "_sync",
                 "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, compile_key, args: dict):
        self.name = name
        self.args = args
        self._tracer = tracer
        self._compile_key = compile_key
        self._sync = None
        self._t0 = 0.0
        self._depth = 0

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
        self._depth = self._tracer._enter()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._sync is not None and _holds_cuda(self._sync):
            import torch

            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._finish(self, self._t0, t1)
        return False


class Tracer:
    """Collects finished spans; exports Chrome-trace JSON + attribution.

    Thread-safe: spans may open/close concurrently on any thread (each
    event records its thread id, and per-thread depth counters keep nesting
    local).  The event buffer is bounded (``max_events``) so a runaway loop
    cannot exhaust memory — overflow increments :attr:`dropped` instead.
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

    def span(self, name: str, *, compile_key=None, **args) -> Span:
        return Span(self, name, compile_key, args)

    # -- span plumbing ------------------------------------------------------

    def _enter(self) -> int:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        return depth

    def _finish(self, span: Span, t0: float, t1: float) -> None:
        self._local.depth = max(getattr(self._local, "depth", 1) - 1, 0)
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
            if len(self._events) < self.max_events:
                self._events.append(event)
            else:
                self.dropped += 1

    # -- introspection / export --------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> set[str]:
        with self._lock:
            return {e["name"] for e in self._events}

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
        """Chrome tracing JSON object format (Perfetto-loadable)."""
        events = self.events()
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "args": {"name": "repro-ptmt"},
        }]
        return {
            "traceEvents": meta + events,
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

    def span(self, name, *, compile_key=None, **args):
        return _NULL_SPAN

    def events(self):
        return []

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
