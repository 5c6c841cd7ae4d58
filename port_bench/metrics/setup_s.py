"""Seconds from the process's start to the first timed request or step:
loading, weights, the stop-head fit, building the kernels (first run in
a checkout), warm-up of the cell's shapes."""


def read(record):
    return record.setup_s
