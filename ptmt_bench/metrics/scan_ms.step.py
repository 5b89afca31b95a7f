"""``scan_ms.step``: the device time per step of the step's ``mine.scan``
spans (the rank's zone scan: B3 and its launch wrapper), from the
program's own timing events, in the window."""

from ptmt_bench.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "mine.scan")
