"""Seconds of audio in the wavs completed inside the window, over the
window's seconds."""


def read(record):
    done = [r for r in record.in_window() if r.ok]
    if not done:
        return None
    return sum(r.wav for r in done) / record.extra['sample_rate'] / record.window_s
