"""What a traffic driver hands back, and the host's own readings.

A driver (``drivers/<name>.py``, named by a traffic mix's ``driver``)
runs an entry's calls through the measured window and returns a
:class:`Window`; the helpers here are shared by every driver.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Window:
    t0: float                       # perf_counter at the window's start
    t1: float                       # perf_counter when the last call ended
    attempted: int
    failed: int
    work: float                     # work units of the completed calls
    kept: list                      # (call index, output) sampled
    spans: list                     # (name, start, end), one per call

    @property
    def completed(self) -> int:
        return self.attempted - self.failed


class Sample:
    """The outputs kept for the comparison with the reference: ``size``
    of them drawn from the seed by reservoir sampling over all completed
    calls, so every call is as likely to be checked."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.kept: list = []
        self.seen = 0

    def offer(self, index: int, out) -> None:
        self.seen += 1
        if self.seen <= self.size:
            self.kept.append((index, out))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = (index, out)


def host_sample() -> dict:
    """The process's CPU seconds and involuntary context switches, and
    the machine's stolen CPU seconds (``/proc/stat``), to tell a slower
    host from more work."""
    import os
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = None
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
            "steal_s": steal}


def host_delta(a: dict, b: dict) -> dict:
    return {k: None if a[k] is None or b[k] is None else b[k] - a[k]
            for k in a}
