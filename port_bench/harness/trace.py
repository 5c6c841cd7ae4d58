"""Spans from the benchmark's own wrappers, and the device trace of a
``--trace 1`` run.

Spans: ``wrap(obj, attr, record, name, attrs)`` replaces a bound method on
one instance by a wrapper that records the host-clock start and end and
what ``attrs(args, result)`` reads from the call; nothing of the program's
source changes.  ``ranged(module, name)`` puts a ``record_function`` around
a module's forward, so that the profiler ties the kernels launched inside
to it.

The device trace: ``torch.profiler`` over the measured window (CUPTI).
``DeviceTrace`` keeps the device operations (kernels, copies and sets),
the union of their intervals (busy seconds), and per annotated range the
device time of the kernels launched inside it.  Its sources: the
profiler's events, as ``chip_smoke.py::device_ms`` and
``tools/gan_step_profile.py`` of the port read them (verdict: sound
sources).
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import common

_LOCK = threading.Lock()


def wrap(obj: Any, attr: str, spans: Dict[str, List[Dict[str, Any]]], name: str,
         attrs: Optional[Callable[[tuple, dict, Any], Dict[str, Any]]] = None) -> None:
    """Record a span per call of ``obj.attr`` under ``spans[name]``, with
    what ``attrs(args, kwargs, result)`` reads from the call."""
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        span = {'start': t0, 'end': time.monotonic(),
                'thread': threading.get_ident()}
        if attrs is not None:
            span.update(attrs(args, kwargs, out))
        with _LOCK:
            spans.setdefault(name, []).append(span)
        return out

    setattr(obj, attr, traced)


def ranged(module: Any, name: str) -> None:
    """A ``record_function(name)`` around every forward of ``module``."""
    import torch
    fn = module.forward

    @functools.wraps(fn)
    def forward(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    module.forward = forward


@dataclass
class DeviceTrace:
    """The device's side of a profiled window (seconds)."""
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]                 # (name, start_s, dur_s)
    range_device_s: Dict[str, List[float]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_s(self, part: str) -> List[float]:
        """Durations of the device operations whose name contains ``part``."""
        return [d for n, _, d in self.ops if part in n]

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        tot: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            tot[n] += d
        return [[n[:120], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the gaps between covered stretches."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def summarize(prof, t0_s: float, t1_s: float, ranges: Tuple[str, ...] = (),
              host_spans: Optional[Dict[str, List[Dict[str, Any]]]] = None) -> DeviceTrace:
    """The device operations of a finished ``torch.profiler.profile``.
    ``ranges``: ``record_function`` names whose kernels' device time is
    summed per call.  ``host_spans`` (monotonic seconds, as ``wrap``
    records them) name the longest idle gaps by the host span that
    covered the gap's middle.  ``t0_s``/``t1_s``: the window on the
    monotonic clock, the profiled one."""
    from torch.autograd import DeviceType
    events = prof.events()
    device_ops = []
    range_names = set(ranges)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in range_names:
            continue
        s, d = e.time_range.start, e.time_range.end - e.time_range.start
        if d <= 0:
            continue
        device_ops.append((e.name, s * 1e-6, d * 1e-6))
    range_device_s: Dict[str, List[float]] = {n: [] for n in ranges}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in range_names:
            range_device_s[e.name].append(e.device_time_total * 1e-6)
    for n, v in range_device_s.items():
        common.log(f'trace: {len(v)} ranges {n}, device s {sum(v)!r}, zero {v.count(0.0)}')
    busy, gaps = _union([(s, s + d) for _, s, d in device_ops])
    window = t1_s - t0_s
    named = []
    if gaps and device_ops:
        # the profiler's clock: microseconds from its own start; map onto
        # the monotonic clock by the first operation against the window
        first = min(s for _, s, _ in device_ops)
        spans = [(v['start'], v['end'], k) for k, vs in (host_spans or {}).items()
                 for v in vs]
        for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = t0_s + (gs + ge) / 2 - first
            what = [k for s, e, k in spans if s <= mid <= e]
            named.append((' + '.join(sorted(set(what))) or 'host', ge - gs))
    return DeviceTrace(window, busy, device_ops, range_device_s, named)
