"""What the program's own tracer gives a traced run's readers.

An entry built with a live ``repro_torch.obs`` bundle returns the
program's host spans from ``Session.spans()`` (so that ``Record.spans``
and the breakdown's idle labels name them), and puts two more things in
the ``context`` its ``check()`` returns:

* ``CONTEXT_DEVICE``: the spans' device intervals, ``(name, start, end)``
  in ``perf_counter`` seconds (``Tracer.intervals()``'s second list);
* ``CONTEXT_COUNTERS``: the registry's counters, as
  ``MetricsRegistry.snapshot()["counters"]`` lists them.

Every function here returns None where the run has no such span or
counter: an untraced run, or a program without them.
"""

from __future__ import annotations

CONTEXT_DEVICE = "program_device_spans"
CONTEXT_COUNTERS = "program_counters"

#: the prefix of the mining step's spans (``distributed/mining.py``)
MINE = "mine."


def device_ms_per_call(record, name: str) -> float | None:
    """Device milliseconds per call inside the window of the device
    intervals of the spans named ``name``."""
    intervals = record.context.get(CONTEXT_DEVICE)
    if not intervals:
        return None
    hits = [b - a for n, a, b in record.in_window(intervals) if n == name]
    return record.per_call_ms(sum(hits)) if hits else None


def counter(record, name: str, **labels) -> float | None:
    """The value of the program's counter ``name`` with exactly these
    labels."""
    for row in record.context.get(CONTEXT_COUNTERS) or ():
        if row["name"] == name and row["labels"] == labels:
            return row["value"]
    return None


def idle_ms_per_call_in(record, prefix: str) -> float | None:
    """Milliseconds per call of the window's device idle time during
    which the host was inside a span whose name starts with ``prefix``
    (the breakdown's labels: the innermost span open at a gap's middle)."""
    if not record.device or not any(
            n.startswith(prefix) for n, _, _ in record.spans):
        return None
    idle = sum(b - a for a, b in record.idle_gaps()
               if record.host_label((a + b) / 2).startswith(prefix))
    return record.per_call_ms(idle)
