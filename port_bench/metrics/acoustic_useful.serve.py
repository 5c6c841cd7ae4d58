"""Real decode steps over the steps paid for, at every
``synthesize_spec_batch`` call in the window: sum of each request's steps
over sum of (rows x the cohort's longest steps).  Padded rows and
early-exit slack count against it."""


def read(record):
    spans = [s for s in record.span('acoustic_stage')
             if record.t_start <= s['start'] <= record.t_end]
    paid = sum(s['rows'] * max(s['steps']) for s in spans)
    real = sum(sum(s['steps'][:s['real']]) for s in spans)
    return 100.0 * real / paid if paid else None
