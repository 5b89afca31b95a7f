"""``merge_live_pct.step``: the live codes the rank sends to the merge as
a share of the rows the merge counts (the program's counters
``repro_mining_live_codes_total`` and ``repro_mining_rows_counted_total``,
``stage="merge"``).  The batch is resident and the same every step, so
the run's ratio is the window's."""

from ptmt_bench.spans import counter

LIVE = "repro_mining_live_codes_total"
ROWS = "repro_mining_rows_counted_total"


def read(record):
    live = counter(record, LIVE, stage="merge")
    rows = counter(record, ROWS, stage="merge")
    if live is None or not rows:
        return None
    return 100.0 * live / rows
