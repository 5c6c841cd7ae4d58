"""Rates and percentiles are taken over every request of the window."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from port_bench.harness import common

METRICS = Path(__file__).resolve().parents[1] / 'metrics'


def reader(name):
    spec = importlib.util.spec_from_file_location(f'm_{name}', METRICS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(latencies_ms, samples=22050, failed=()):
    rec = common.Record(cell={}, workload={}, seed=0, trace=False,
                        t_start=100.0, t_end=110.0, extra={'sample_rate': 22050})
    for i, lat in enumerate(latencies_ms):
        sent = 100.0 + 0.005 * i
        r = common.Request(text=0, sent=sent, done=sent + lat / 1e3, wav=samples)
        if i in failed:
            r.error = 'boom'
        rec.requests.append(r)
    return rec


def test_p95_over_all_requests():
    """Not a median of chunk percentiles: one slow chunk shows in full."""
    lat = [10.0] * 900 + [1000.0] * 100
    got = reader('latency_p95_ms')(record(lat))
    assert got == pytest.approx(float(np.percentile(lat, 95)))
    chunks = np.median([np.percentile(lat[k:k + 100], 95) for k in range(0, 1000, 100)])
    assert got == pytest.approx(1000.0) and chunks == pytest.approx(10.0)


def test_p95_from_send():
    rec = record([100.0] * 50)
    rec.requests[-1].sent -= 1.0                 # sent a second earlier
    assert rec.latency_ms(rec.requests[-1]) == pytest.approx(1100.0)
    assert reader('latency_p95_ms')(rec) == pytest.approx(
        float(np.percentile([100.0] * 49 + [1100.0], 95)))


def test_failed_request_misses_the_tail():
    assert reader('latency_p95_ms')(record([10.0] * 10, failed=range(5))) is None
    assert reader('latency_p95_ms')(record([10.0] * 100, failed=(3,))) == pytest.approx(10.0)


def test_requests_outside_the_window_do_not_count():
    rec = record([10.0] * 10)
    rec.requests.append(common.Request(text=0, sent=90.0, done=99.0, wav=22050))
    rec.requests.append(common.Request(text=0, sent=109.9, done=111.0, wav=22050))
    assert reader('audio_s_per_s')(rec) == pytest.approx(10 * 1.0 / 10.0)


def test_audio_rate_is_all_audio_over_the_window():
    rec = record([10.0] * 37, samples=2 * 22050)
    assert reader('audio_s_per_s')(rec) == pytest.approx(37 * 2.0 / 10.0)
    rec.requests[0].error = 'boom'
    assert reader('audio_s_per_s')(rec) == pytest.approx(36 * 2.0 / 10.0)


def test_gan_rate():
    rec = common.Record(cell={}, workload={}, seed=0, trace=False,
                        t_start=0.0, t_end=12.5, steps=50, audio_s_per_step=5.944)
    assert reader('gan_audio_s_per_s')(rec) == pytest.approx(50 * 5.944 / 12.5)


def test_useful_shares():
    rec = record([10.0])
    rec.spans = {'acoustic_stage': [{'start': 101.0, 'end': 101.05, 'rows': 8, 'n': 32,
                                     'steps': [10, 20, 10, 10, 10, 10, 10, 10],
                                     'real': 2}],
                 'vocoder_stage': [{'start': 101.0, 'end': 101.06, 'rows': 8,
                                    'frames': [100, 120], 'bucket': 128}]}
    assert reader('acoustic_useful.serve')(rec) == pytest.approx(100 * 30 / (8 * 20))
    assert reader('vocoder_useful.serve')(rec) == pytest.approx(100 * 220 / (8 * 128))
    assert reader('acoustic_stage_ms.serve')(rec) == pytest.approx(50.0)


def test_no_trace_no_device_metric():
    rec = record([10.0])
    for name in ('device_idle.serve', 'decode_full_roofline.serve',
                 'generator_device_ms.serve', 'launches_per_step.gan'):
        assert reader(name)(rec) is None
