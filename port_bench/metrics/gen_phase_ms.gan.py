"""Mean device time of a ``generator_phase`` call (the generator's
update), by CUDA events around each call in the window."""


def read(record):
    calls = record.span('generator_phase')
    return sum(c['ms'] for c in calls) / len(calls) if calls else None
