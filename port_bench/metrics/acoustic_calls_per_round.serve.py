"""Mean batched calls per acoustic collection round ended in the window:
the bucket groups a round of submissions splits into, and any solo
retries (the port's ``batch-acoustic.round`` spans and the
``batch-acoustic.call`` spans they cause)."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.calls_per_round(record, 'batch-acoustic')
