"""Driver ``closed_loop``: one caller that sends its next call only once
the last one has returned, back to back through the window.

A traffic mix that names it (``"driver": "closed_loop"``) sets:

* ``callers``: 1, the one caller this driver runs;
* ``warm_calls``: calls made in set-up, before the window, with the same
  inputs as the window's, so that every kernel is built and every cache
  the program keeps across calls is filled as a user's second call finds
  it;
* ``check_sample``: how many of the window's outputs are kept for the
  comparison with the reference, drawn from the seed.

Each call returns once its output is complete on the host or
synchronized on the device: the entry's ``call`` does that.  The call
running when the window's time is up completes, and its time and work
count.
"""

from __future__ import annotations

import sys
import time
import traceback

from ptmt_bench.window import Sample, Window


def _check(traffic: dict) -> None:
    if traffic.get("callers") != 1:
        raise ValueError(f"traffic {traffic.get('name')!r}: the closed "
                         "loop runs one caller")


def warm(session, traffic: dict) -> None:
    _check(traffic)
    for _ in range(int(traffic["warm_calls"])):
        session.call()


def run_window(session, traffic: dict, *, seconds: float,
               seed: int) -> Window:
    _check(traffic)
    sample = Sample(int(traffic["check_sample"]), seed)
    spans: list = []
    attempted = failed = 0
    work = 0.0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        i = attempted
        attempted += 1
        c0 = time.perf_counter()
        try:
            out = session.call()
        except Exception:       # a failed call is counted and reported
            failed += 1
            traceback.print_exc(file=sys.stderr)
            continue
        spans.append(("ptmt_bench.call", c0, time.perf_counter()))
        work += session.work_per_call
        sample.offer(i, out)
        del out
    t1 = time.perf_counter()
    return Window(t0=t0, t1=t1, attempted=attempted, failed=failed,
                  work=work, kept=sample.kept, spans=spans)
