"""Mean host-clock time of a ``synthesize_spec_batch`` call in the window
(it ends on the specs' copy to the host)."""


def read(record):
    spans = [s for s in record.span('acoustic_stage')
             if record.t_start <= s['start'] <= record.t_end]
    return 1e3 * sum(s['end'] - s['start'] for s in spans) / len(spans) if spans else None
