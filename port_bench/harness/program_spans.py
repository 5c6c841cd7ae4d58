"""The port's own spans (``transtacos_retunegan_tpu_torch/utils/tracing.py``)
for the per-layer metrics that read them, and the offset that puts them
onto the device trace's clock.

The tracer records while the profiler of a ``--trace 1`` run records, so
a traced run holds spans of its profiled window and an untraced one none.
A program without the tracer (a commit before it) gives no spans, and
every reader then returns None.

Alignment (``align``): the device trace keeps each operation's start in
seconds from the profiler's own start, and the spans are on the monotonic
clock.  Each ``decode_full`` launch records its host time just before the
launch call and the time its error word was read, which waits for the
kernel.  Launches on one card hold a lock from launch to read, so each
such window holds one ``decode_full_kernel``, and a pair of launch and
kernel bounds the offset between the clocks (device-trace seconds minus
monotonic seconds): a kernel cannot start before its launch (the offset
is at most kernel start minus launch), nor end after its read (at least
kernel end minus read).  At the serving cell's idle share most kernels
start within a tenth of a millisecond, so most pairs pin the offset to
that.

One offset does not hold for a whole window: the profiler stamps its
events on the wall clock, which the host's time service slews and steps
(on the H100 hosts: 1.2 and 6.7 ms/s, and steps of 4.3 and 28 ms, in 2
of 5 traced windows).  So each pair whose bounds lie under
``TOLERANCE_S`` apart gives the offset at its launch, the middle of its
bounds (its ``spread``, the distance between them, is the most that can
be off by twice), and ``Alignment.offset_at`` interpolates between
pairs.  Pairs are taken in order, from each of a few shifts of the first
pair (a launch before the profile's first event, or a kernel of a launch
the tracer did not see); the shift kept is the one whose offsets move
least from pair to pair.  A wrong pairing moves the offset by the
launches' spacing, tens of milliseconds, at every pair; ``align`` gives
None where that median rate passes ``MOST_SLEW``, where fewer than
``LEAST_PAIRS`` pairs hold under the tolerance, or where under
``LEAST_SHARE`` of the pairs have bounds that meet at all.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import common

TOLERANCE_S = 1e-3
LEAST_PAIRS = 10
LEAST_SHARE = 0.9
MOST_SLEW = 0.02
SHIFTS = 3
CALLS = ('batch-acoustic.call', 'batch-vocoder.call')


def every(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> list:
    """The spans the tracer kept that ended in ``[t0_ns, t1_ns]``, or []
    without a tracer."""
    try:
        from transtacos_retunegan_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans(t0_ns, t1_ns)


def in_window(record) -> list:
    """The spans that ended inside the record's window."""
    return every(int(record.t_start * 1e9), int(record.t_end * 1e9))


def queue_ms(record, coalescer: str) -> Optional[float]:
    """Mean wait of the submissions whose call started in the window."""
    waits = [s for s in in_window(record) if s.name == f'{coalescer}.wait']
    return sum(s.end - s.start for s in waits) / len(waits) / 1e6 if waits else None


def calls_per_round(record, coalescer: str) -> Optional[float]:
    """Mean batched calls (solo retries too) per round ended in the window."""
    rounds = [s for s in in_window(record) if s.name == f'{coalescer}.round']
    if not rounds:
        return None
    calls: Dict[int, int] = defaultdict(int)
    for s in every():
        if s.name == f'{coalescer}.call':
            calls[s.parent] += 1
    return sum(calls[r.id] for r in rounds) / len(rounds)


def part_ms(record, part: str) -> Optional[float]:
    """Mean host ms per call in ``part``: the spans of that name ended in
    the window, summed per call that caused them (the pieces of a call on
    several threads or replicas add up)."""
    per_call: Dict[int, int] = defaultdict(int)
    for s in in_window(record):
        if s.name == part:
            per_call[s.parent] += s.end - s.start
    return sum(per_call.values()) / len(per_call) / 1e6 if per_call else None


def launches(spans: Iterable) -> List[Tuple[float, Optional[float]]]:
    """(launch, read) seconds of every recorded ``decode_full`` launch, in
    order of launch."""
    out = []
    for s in spans:
        at = s.attrs.get('decode_full_launch_ns', [])
        done = s.attrs.get('decode_full_done_ns', [])
        out += [(t / 1e9, done[i] / 1e9 if i < len(done) else None)
                for i, t in enumerate(at)]
    return sorted(out)


@dataclass
class Alignment:
    """The offset (device-trace seconds minus monotonic seconds) at the
    launches of the pairs that pin it, and how far each can be off."""
    at: List[float]              # host seconds of those launches
    offsets: List[float]
    spreads: List[float]         # upper minus lower bound of each
    pairs: int                   # pairs whose bounds meet, tight or not
    slew: float                  # median rate of change of the offset, s/s

    def offset_at(self, t: float) -> float:
        """The offset at host time ``t``, interpolated between pairs."""
        return float(np.interp(t, self.at, self.offsets))


def _pinned(pairs, tolerance: float) -> Optional[Alignment]:
    """The alignment of ``pairs`` of ``((launch, read), (start, duration))``."""
    at, offsets, spreads, met = [], [], [], 0
    for (launch, read), (start, dur) in pairs:
        lower, upper = start + dur - read, start - launch
        met += lower <= upper
        if 0.0 <= upper - lower <= tolerance:
            at.append(launch)
            offsets.append((lower + upper) / 2)
            spreads.append(upper - lower)
    if len(at) < 2:
        return None
    rates = np.abs(np.diff(offsets)) / np.maximum(np.diff(at), 1e-9)
    return Alignment(at, offsets, spreads, met, float(np.median(rates)))


def align(host: Sequence[Tuple[float, Optional[float]]],
          kernels: Sequence[Tuple[float, float]],
          tolerance: float = TOLERANCE_S, least: int = LEAST_PAIRS,
          shifts: int = SHIFTS) -> Optional[Alignment]:
    """The offsets that map monotonic seconds onto the device trace's
    clock, from ``host`` (launch, read) times and the traced kernels'
    ``(start, duration)``; None where the pairs do not hold together."""
    host = sorted(h for h in host if h[1] is not None)
    kernels = sorted(kernels)
    best = None
    for shift in range(-shifts, shifts + 1):
        got = _pinned(list(zip(host[max(0, -shift):], kernels[max(0, shift):])), tolerance)
        if got is not None and (best is None or got.slew < best.slew):
            best = got
    if (best is None or len(best.at) < least or best.slew > MOST_SLEW
            or best.pairs < LEAST_SHARE * min(len(host), len(kernels))):
        return None
    return best


def device_clock(record) -> Optional[Alignment]:
    """``align`` over the run's launches and its traced ``decode_full``
    kernels, logged on standard error."""
    if record.device is None:
        return None
    kernels = [(s, d) for n, s, d in record.device.ops if 'decode_full_kernel' in n]
    host = launches(every())
    got = align(host, kernels)
    if got is None:
        common.log(f'program spans: no alignment of {len(host)} decode_full launches '
                   f'with {len(kernels)} traced kernels')
    else:
        first = min(s for _, s, _ in record.device.ops)
        common.log(f'program spans: {len(got.at)} of {len(host)} launches pin the offset '
                   f'({len(kernels)} kernels): {got.offsets[0]!r} s at the first, moving '
                   f'{max(got.offsets) - min(got.offsets)!r} s, {got.slew!r} s/s at the '
                   f'median; spread median {float(np.median(got.spreads))!r} s, largest '
                   f'{max(got.spreads)!r} s; mapping the first operation to t_start is '
                   f'off by {record.t_start - first + got.offset_at(record.t_start)!r} s')
    return got


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length covered by both of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_calls(record) -> Optional[float]:
    """Percent of the device's idle time in the window (on the device
    trace's clock) during which a batched call span was open."""
    clock = device_clock(record)
    if clock is None:
        return None
    t0 = record.t_start + clock.offset_at(record.t_start)
    t1 = record.t_end + clock.offset_at(record.t_end)
    busy = merged((max(s, t0), min(s + d, t1)) for _, s, d in record.device.ops
                  if s < t1 and s + d > t0)
    idle, at = [], t0
    for s, e in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, e)
    if at < t1:
        idle.append((at, t1))
    calls = merged((s.start / 1e9 + clock.offset_at(s.start / 1e9),
                    s.end / 1e9 + clock.offset_at(s.end / 1e9))
                   for s in every() if s.name in CALLS)
    idle_s = sum(e - s for s, e in idle)
    return 100.0 * overlap(idle, calls) / idle_s if idle_s > 0 else None
