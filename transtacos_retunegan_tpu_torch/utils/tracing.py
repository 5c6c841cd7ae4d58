"""Spans of the port's serving path, kept in memory.

A span is a stretch of host time: its name, start and end on
``time.monotonic_ns()``, the thread it ran on, its own id, the id of the
span that caused it (``parent``, 0 for none) and a few numbers
(``attrs``).  Finished spans go to one process-wide list of at most
``CAP``; past it they are only counted (``dropped()``).  ``spans(t0, t1)``
hands out those that ended inside a window.

The tracer records while a ``torch.profiler`` profile is recording, on
every thread, or between ``enable()`` and ``disable()``.  The switch is
torch's process-wide ``torch.autograd.profiler._is_profiler_enabled``:
the C-level ``_profiler_enabled()`` is per thread, and the serving
dispatchers are threads other than the one that opened the profile.  Off,
each site costs one flag check: no clock read, no allocation, no lock.
Spans are not profiler ranges: a ``record_function`` would put a range of
its name on the device timeline of a trace, where it would count as
device work.

Each time the tracer switches on it keeps one anchor (``anchors()``):
``(time.monotonic_ns(), time.time_ns())`` read back to back.  Kineto
stamps its events on the wall clock, so a reader that has a profile's
``trace_start_ns`` can put spans onto the device trace's clock, for as
long as the host's time service does not step or slew the wall clock.

Sites: ``span(name)`` is a context manager that yields the open ``Span``
(None when off), child of the innermost span open on its thread;
``begin``/``begin_many``/``end`` open and close spans that do not nest;
``stamp`` and ``record`` time a stretch that starts on one thread and is
closed on another (a queue's wait); ``bind`` carries the caller's open
span to a function run on another thread; ``mark`` adds the time of a
point (a kernel launch) to the innermost open span.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler

CAP = 200_000

_spans: List['Span'] = []
_dropped = 0
_anchors: List[Tuple[int, int]] = []
_forced = False
_anchored = False
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One stretch of host time (nanoseconds on ``time.monotonic_ns()``)."""

    __slots__ = ('name', 'start', 'end', 'thread', 'id', 'parent', 'attrs')

    def __init__(self, name: str, parent: Optional[int] = None, start: int = 0,
                 end: int = 0, thread: int = 0, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.parent = parent
        self.start = start
        self.end = end
        self.thread = thread or threading.get_ident()
        self.id = next(_ids)
        self.attrs = attrs if attrs is not None else {}

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6

    def __enter__(self) -> 'Span':
        stack = _stack()
        if self.parent is None:
            self.parent = _top_id(stack)
        stack.append(self)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.monotonic_ns()
        _stack().pop()
        _store(self)
        return False

    def __repr__(self) -> str:
        return (f'Span({self.name!r}, id={self.id}, parent={self.parent}, '
                f'{self.ms:.3f} ms, {self.attrs})')


class _Off:
    """What ``span`` returns while the tracer is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def on() -> bool:
    """Whether the tracer records; keeps an anchor at each switch-on."""
    global _anchored
    if _forced or _profiler._is_profiler_enabled:
        if not _anchored:
            _anchor()
        return True
    if _anchored:
        _anchored = False
    return False


def _anchor() -> None:
    global _anchored
    with _lock:
        if not _anchored:
            _anchors.append((time.monotonic_ns(), time.time_ns()))
            _anchored = True


def _stack() -> list:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _top_id(stack: list) -> int:
    """The id of the innermost open span (or bound cause) of a stack."""
    if not stack:
        return 0
    top = stack[-1]
    return top.id if isinstance(top, Span) else top


def _store(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAP:
            _spans.append(span)
        else:
            _dropped += 1


# -- switch and readers -------------------------------------------------------
def enable() -> None:
    """Record from now on, with or without a profiler."""
    global _forced
    _forced = True
    on()


def disable() -> None:
    """Stop recording unless a profiler is recording."""
    global _forced
    _forced = False
    on()


def clear() -> None:
    """Forget every span, anchor and drop (the next site that finds the
    tracer on keeps a new anchor)."""
    global _dropped, _anchored
    with _lock:
        _spans.clear()
        _anchors.clear()
        _dropped = 0
        _anchored = False


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None,
          name: Optional[str] = None) -> List[Span]:
    """Finished spans (of ``name``) that ended in ``[t0_ns, t1_ns]``."""
    with _lock:
        out = list(_spans)
    return [s for s in out if (name is None or s.name == name)
            and (t0_ns is None or s.end >= t0_ns) and (t1_ns is None or s.end <= t1_ns)]


def dropped() -> int:
    """Spans not kept because the list was full."""
    return _dropped


def anchors() -> List[Tuple[int, int]]:
    """``(monotonic_ns, time_ns)`` read at each switch-on."""
    with _lock:
        return list(_anchors)


# -- sites --------------------------------------------------------------------
def span(name: str, parent: Optional[int] = None):
    """``with span(name) as s:`` times the block; ``s`` is the open
    ``Span``, or None while the tracer is off.  ``parent`` defaults to the
    innermost span open on this thread."""
    if not on():
        return _OFF
    return Span(name, parent)


def begin(name: str) -> Optional[Span]:
    """Open a span that does not nest (``end`` closes it); None when off."""
    if not on():
        return None
    return Span(name, 0, start=time.monotonic_ns())


def begin_many(name: str, n: int) -> Sequence[Span]:
    """``n`` spans opened at one instant; ``()`` when off."""
    if not on():
        return ()
    t = time.monotonic_ns()
    return tuple(Span(name, 0, start=t) for _ in range(n))


def end(span: Optional[Span]) -> None:
    """Close and keep a span from ``begin`` (None: nothing)."""
    if span is not None:
        span.end = time.monotonic_ns()
        _store(span)


def stamp(parent: int = 0) -> Optional[Tuple[int, int, int]]:
    """``(now, parent, thread)`` for a stretch another thread closes with
    ``record``; None when off."""
    if not on():
        return None
    return time.monotonic_ns(), parent, threading.get_ident()


def record(name: str, stamped: Tuple[int, int, int], end_ns: int, **attrs) -> None:
    """Keep the span from a ``stamp`` to ``end_ns`` (on the stamping thread)."""
    t0, parent, thread = stamped
    _store(Span(name, parent, t0, end_ns, thread, attrs))


def bind(fn: Callable) -> Callable:
    """``fn`` whose spans, on whatever thread it runs, are children of the
    span open here; ``fn`` itself when off."""
    if not on():
        return fn
    cause = _top_id(_stack())

    def bound(*args, **kwargs):
        stack = _stack()
        stack.append(cause)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()

    return bound


def mark(key: str) -> None:
    """Add the time now to ``attrs[key]`` (a list) of the innermost span
    open on this thread, if one is."""
    if not on():
        return
    t = time.monotonic_ns()
    for s in reversed(_stack()):
        if isinstance(s, Span):
            s.attrs.setdefault(key, []).append(t)
            return
