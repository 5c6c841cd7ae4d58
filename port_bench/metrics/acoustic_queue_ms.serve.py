"""Mean wait of an acoustic submission, from ``Coalescer.submit`` to the
start of the batched call that carries it, over the submissions whose
call started in the window (the port's ``batch-acoustic.wait`` spans)."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.queue_ms(record, 'batch-acoustic')
