"""One module per kind of window, named by a workload file's ``driver``
key.  Each has ``measure(record)`` (set-up and the window; returns what
``verify`` needs) and ``verify(record, state)`` (the comparison with the
reference, after the peak memory has been read; returns the checks)."""
