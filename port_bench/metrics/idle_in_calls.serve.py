"""Share of the device's idle time in the window during which at least one
batched call span (``batch-acoustic.call``, ``batch-vocoder.call``) was
open; the rest is idle while both dispatchers collected or waited.  The
spans are put onto the device trace's clock by the ``decode_full``
launches (``program_spans.align``); None where they do not align."""

from port_bench.harness import program_spans


def read(record):
    return program_spans.idle_in_calls(record)
