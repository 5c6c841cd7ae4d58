"""Mean device time of a ``discriminator_phase`` call (its d_train_times
AdamW updates), by CUDA events around each call in the window."""


def read(record):
    calls = record.span('discriminator_phase')
    return sum(c['ms'] for c in calls) / len(calls) if calls else None
