"""``merge_ms.step``: the device time per step of the step's
``mine.merge`` span (compaction to ``out_cap`` rows, the all-gathers, the
merge's signed count and the overflow flag's sum), from the program's
own timing events, in the window."""

from ptmt_bench.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "mine.merge")
