"""``idle_pct.step``: the share of the mining-step window in which no
operation ran on the card (the window less the union of the profiler's
device activities)."""


def read(record):
    return record.idle_pct()
