"""Logging helpers, ported from ``transtacos_retunegan_tpu/utils/logging.py``:
a stdout + file logger, a rolling-average window and the process's
resident set size.  The JAX module's wall-time decorator ``timer`` is not
ported: the port times its serving path with spans (``utils/tracing.py``)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def get_logger(name: str, log_path: Optional[str] = None,
               primary: bool = True) -> logging.Logger:
    """Dual stdout+file logger (reference ``transtacos/utils.py:14-38``);
    with ``primary`` False (a data-parallel rank other than 0) it writes
    nothing.

    ``logging`` caches loggers by name, so a second training run in the same
    process (tests, notebooks) would otherwise silently keep writing to the
    FIRST run's log file; the file handler is re-pointed per call instead.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not primary:
        # under data parallelism only rank 0 writes the run's log
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter('%(asctime)s %(message)s', '%H:%M:%S')
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_path:
        log_path = os.path.abspath(log_path)
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                if h.baseFilename == log_path:
                    break
                logger.removeHandler(h)
                h.close()
        else:
            os.makedirs(os.path.dirname(log_path) or '.', exist_ok=True)
            fh = logging.FileHandler(log_path, 'a', encoding='utf-8')
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        # a pathless call must not silently append to a PREVIOUS run's file
        for h in list(logger.handlers):
            if isinstance(h, logging.FileHandler):
                logger.removeHandler(h)
                h.close()
    return logger


def host_rss_gb() -> float:
    """Current resident set size of this process in GiB (Linux VmRSS;
    falls back to the ru_maxrss high-water mark elsewhere)."""
    try:
        with open('/proc/self/status') as fh:
            for line in fh:
                if line.startswith('VmRSS:'):
                    return int(line.split()[1]) / (1024 ** 2)
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1024 ** 2)


class ValueWindow:
    """Rolling average window (reference ``transtacos/utils.py:72-94``)."""

    def __init__(self, window_size: int = 100):
        self._size = window_size
        self._values = []

    def append(self, x: float):
        self._values = self._values[-(self._size - 1):] + [float(x)]

    @property
    def sum(self) -> float:
        return sum(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)

    def reset(self):
        self._values = []

