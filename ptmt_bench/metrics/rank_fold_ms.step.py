"""``rank_fold_ms.step``: the device time per step of the step's
``mine.fold`` spans (the rank's signed count of its own slots,
``aggregate_zones``, and the bounded merges of the chunked route), from
the program's own timing events, in the window."""

from ptmt_bench.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "mine.fold")
