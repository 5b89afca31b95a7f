"""``fold_ms.step``: the mining step's device time outside B3 per step:
the fold (``aggregation.count_codes``' sorts, gathers and ``index_add_``),
the merge's all-gather and the overflow flag, from the profiler's trace
(the union of device activity less B3's kernel time)."""

from ptmt_bench.roofline.zone_scan import is_b3


def read(record):
    if not record.device:
        return None
    return record.per_call_ms(record.busy_s() - record.device_s(is_b3))
