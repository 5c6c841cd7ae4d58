"""Mean host ms per vocoder call in the port's ``vocoder.prep`` spans (the
specs oriented, DC-restored and padded in numpy, the phase drawn, and the
copy to the card), over the calls whose spans ended in the window."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.part_ms(record, 'vocoder.prep')
