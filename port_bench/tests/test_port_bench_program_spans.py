"""The readers of the port's own spans (``harness/program_spans.py`` and
the metrics that use it) on synthetic spans and device traces: their
arithmetic, None where there is nothing to read, and the alignment of the
spans with the device trace's clock."""

import importlib.util
import itertools
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench.harness import common, program_spans
from port_bench.harness.trace import DeviceTrace

METRICS = Path(__file__).resolve().parents[1] / 'metrics'
NAMES = ('acoustic_queue_ms.serve', 'vocoder_queue_ms.serve',
         'acoustic_calls_per_round.serve', 'acoustic_text_ms.serve',
         'acoustic_sync_ms.serve', 'vocoder_prep_ms.serve', 'vocoder_sync_ms.serve',
         'idle_in_calls.serve')
OFFSET = -999.0                  # device-trace seconds minus monotonic seconds
_ids = itertools.count(1)


def reader(name):
    spec = importlib.util.spec_from_file_location(f'ps_{name}', METRICS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, start_s, end_s, parent=0, **attrs):
    return SimpleNamespace(name=name, start=round(start_s * 1e9), end=round(end_s * 1e9),
                           id=next(_ids), parent=parent, attrs=attrs)


def record(t0=1000.0, t1=1001.2, device=None):
    return common.Record(cell={}, workload={}, seed=0, trace=True, t_start=t0, t_end=t1,
                         device=device)


@pytest.fixture
def spans(monkeypatch):
    """The spans ``every`` hands the readers, as the tracer keeps them."""
    kept = []

    def every(t0_ns=None, t1_ns=None):
        return [s for s in kept if (t0_ns is None or s.end >= t0_ns)
                and (t1_ns is None or s.end <= t1_ns)]
    monkeypatch.setattr(program_spans, 'every', every)
    return kept


def test_queue_round_and_part_arithmetic(spans):
    r1 = span('batch-acoustic.round', 1000.1, 1000.106)
    r2 = span('batch-acoustic.round', 1000.5, 1000.506)
    late = span('batch-acoustic.round', 1001.19, 1001.21)
    a = span('batch-acoustic.call', 1000.11, 1000.15, r1.id)
    b = span('batch-acoustic.call', 1000.15, 1000.19, r1.id)
    c = span('batch-acoustic.call', 1000.51, 1000.55, r2.id)
    spans += [r1, r2, late, a, b, c, span('batch-acoustic.call', 1001.2, 1001.3, late.id),
              span('batch-acoustic.wait', 1000.098, 1000.1),
              span('batch-acoustic.wait', 1000.096, 1000.1),
              span('batch-acoustic.wait', 999.0, 999.5),             # before the window
              span('batch-vocoder.wait', 1000.2, 1000.21),
              span('acoustic.text', 1000.11, 1000.111, a.id),
              span('acoustic.text', 1000.15, 1000.152, b.id),
              span('acoustic.text', 1000.16, 1000.161, b.id),       # a second piece
              span('acoustic.sync', 1000.14, 1000.15, a.id)]
    rec = record()
    assert reader('acoustic_queue_ms.serve')(rec) == pytest.approx(3.0)
    assert reader('vocoder_queue_ms.serve')(rec) == pytest.approx(10.0)
    assert reader('acoustic_calls_per_round.serve')(rec) == pytest.approx(1.5)
    assert reader('acoustic_text_ms.serve')(rec) == pytest.approx(2.0)
    assert reader('acoustic_sync_ms.serve')(rec) == pytest.approx(10.0)
    assert reader('vocoder_prep_ms.serve')(rec) is None


def test_nothing_to_read_gives_none(spans):
    device = DeviceTrace(1.2, 0.1, [('decode_full_kernel', 0.1, 0.01)])
    for name in NAMES:
        assert reader(name)(record(device=device)) is None, name


def test_a_program_without_the_tracer_gives_no_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, 'transtacos_retunegan_tpu_torch.utils.tracing', None)
    assert program_spans.every() == []


def launches(n=40, seed=0):
    """(launch, read) host seconds, and the kernels' (start, duration) on
    the device trace's clock: most start 20 us after their launch, every
    third behind other work for 0.2-3 ms; reads come 40 us after the end."""
    rng = np.random.RandomState(seed)
    at = 1000.0 + np.cumsum(rng.uniform(0.01, 0.05, n))
    lag = np.where(np.arange(n) % 3 == 0, rng.uniform(2e-4, 3e-3, n), 2e-5)
    dur = rng.uniform(0.008, 0.016, n)
    host = [(float(t), float(t + g + d + 4e-5)) for t, g, d in zip(at, lag, dur)]
    kernels = [(float(t + g + OFFSET), float(d)) for t, g, d in zip(at, lag, dur)]
    return host, kernels


def pins(got, host, kernels, pairs, drift=lambda t: 0.0):
    """Every pair is found, and where the tracer's bounds pin the offset
    the alignment is off by at most half their spread."""
    assert got is not None and got.pairs == pairs and len(got.at) >= 0.6 * pairs
    for t, spread in zip(got.at, got.spreads):
        assert abs(got.offset_at(t) - (OFFSET - drift(t))) <= spread / 2 + 1e-9
        assert spread <= 1e-3


def test_alignment_pairs_launches_with_kernels():
    host, kernels = launches()
    got = program_spans.align(host, kernels)
    pins(got, host, kernels, 40)
    assert np.median(got.spreads) == pytest.approx(6e-5) and got.slew < 1e-9


def test_alignment_with_the_first_launch_missing_from_the_trace():
    host, kernels = launches()
    pins(program_spans.align(host, kernels[1:]), host, kernels, 39)
    pins(program_spans.align(host[2:], kernels), host, kernels, 38)   # kernels before


def test_alignment_of_a_clipped_window():
    host, kernels = launches()
    pins(program_spans.align(host, kernels[3:-5]), host, kernels, 32)
    assert program_spans.align(host[:9], kernels[:9]) is None        # too few pairs


@pytest.mark.parametrize('step, slew', [(4.3e-3, 1.2e-3), (-28e-3, 6.7e-3)])
def test_alignment_follows_a_stepped_and_slewed_wall_clock(step, slew):
    """The trace's clock steps after the 25th kernel and slews from there,
    as the card's hosts did in 2 of 5 traced windows."""
    host, kernels = launches(60)
    t25 = host[25][0]

    def drift(t):
        return step + slew * (t - t25) if t >= t25 else 0.0
    moved = [(s - drift(h[0]), d) for h, (s, d) in zip(host, kernels)]
    got = program_spans.align(host, moved)
    pins(got, host, moved, 60, drift)
    assert max(got.offsets) - min(got.offsets) >= abs(step)


def test_inconsistent_pairs_give_none():
    host, kernels = launches()
    rng = np.random.RandomState(1)
    jumbled = [(s + rng.uniform(-0.02, 0.02), d) for s, d in kernels]
    assert program_spans.align(host, jumbled) is None
    # kernels that run longer than the host waited for them
    assert program_spans.align(host, [(s, d + 0.01) for s, d in kernels]) is None
    # every read 2 ms after its kernel: the offset is known only to 2 ms
    slack = [(launch, done + 2e-3) for launch, done in host]
    assert program_spans.align(slack, kernels, tolerance=1e-3) is None
    assert np.median(program_spans.align(slack, kernels, tolerance=3e-3).spreads) == \
        pytest.approx(2.06e-3)


def test_idle_in_calls(spans):
    """Twelve 10 ms kernels, each inside a 20 ms acoustic call, in a 1.2 s
    window; one vocoder call overlaps the first acoustic call by 5 ms."""
    at = [1000.05 + 0.1 * i + 1e-3 * (i * i % 7) for i in range(12)]
    ops = [('decode_full_kernel', t + 1e-5 + OFFSET, 0.01) for t in at]
    for t in at:
        launch = span('acoustic.launch', t - 1e-3, t + 0.0101,
                      decode_full_launch_ns=[round(t * 1e9)],
                      decode_full_done_ns=[round((t + 0.01005) * 1e9)])
        spans += [launch, span('batch-acoustic.call', t - 0.005, t + 0.015)]
    spans.append(span('batch-vocoder.call', at[0] + 0.01, at[0] + 0.03))
    got = reader('idle_in_calls.serve')(record(device=DeviceTrace(1.3, 0.12, ops)))
    # idle 1.2 - 0.12 s; calls cover 11 x 10 ms of it, and 25 ms around the first
    assert got == pytest.approx(100.0 * (0.11 + 0.025) / 1.08, rel=1e-6)
