"""Mean host ms per acoustic call in the port's ``acoustic.text`` spans
(the host text frontend and the batch's assembly), over the calls whose
spans ended in the window."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.part_ms(record, 'acoustic.text')
