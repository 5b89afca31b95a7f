"""``launch_idle_ms.step``: the card's idle time per step while the host
was inside one of the mining step's ``mine.*`` spans (the profiler's
device activity for the gaps, the program's host spans for their
labels): the time the step's own host code kept the card waiting."""

from ptmt_bench.spans import MINE, idle_ms_per_call_in


def read(record):
    return idle_ms_per_call_in(record, MINE)
