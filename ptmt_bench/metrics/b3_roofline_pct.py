"""``b3_roofline_pct``: the least time of one step's zone scan
(``ptmt_bench.roofline.zone_scan``, the lane-steps the batch needs) as a
share of the device time per step of the dense kernel B3
(``zone_scan.cu``), from the profiler's trace."""

from ptmt_bench.roofline.zone_scan import is_b3


def read(record):
    return record.roofline_pct(record.context.get("b3"), is_b3)
