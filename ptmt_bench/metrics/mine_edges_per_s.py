"""``mine_edges_per_s``: valid slots (edges) of all the mining steps that
completed in the window over the window's whole time, from its start to
the end of its last step (host clock)."""


def read(record):
    return record.rate()
