"""Mean host ms per acoustic call in the port's ``acoustic.sync`` spans
(``_natural_specs``: the specs' copy to the host, which waits for the
card), over the calls whose spans ended in the window."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.part_ms(record, 'acoustic.sync')
