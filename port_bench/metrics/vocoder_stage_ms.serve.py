"""Mean host-clock time of a ``vocode_batch`` call in the window."""


def read(record):
    spans = [s for s in record.span('vocoder_stage')
             if record.t_start <= s['start'] <= record.t_end]
    return 1e3 * sum(s['end'] - s['start'] for s in spans) / len(spans) if spans else None
