"""Mean host ms per vocoder call in the port's ``vocoder.sync`` spans (the
wav's copy to the host, which waits for the card), over the calls whose
spans ended in the window."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.part_ms(record, 'vocoder.sync')
