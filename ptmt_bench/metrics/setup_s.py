"""``setup_s``: seconds from the start of the run's process to the first
call of the window: imports, the card's start, the kernels' build (in
the first run of a checkout), the inputs made from the seed, the
program's entry built and its warm-up calls (host clock)."""


def read(record):
    return record.setup_s
