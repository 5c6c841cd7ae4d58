"""Real frames over the frames paid for, at every ``vocode_batch`` call in
the window: sum of each request's frames over sum of (rows x the bucket's
frames)."""


def read(record):
    spans = [s for s in record.span('vocoder_stage')
             if record.t_start <= s['start'] <= record.t_end]
    paid = sum(s['rows'] * s['bucket'] for s in spans)
    real = sum(sum(s['frames']) for s in spans)
    return 100.0 * real / paid if paid else None
