"""The port's tracer (``transtacos_retunegan_tpu_torch/utils/tracing.py``)
on its serving path, on the CPU: off, the sites store nothing and read no
clock; on, every wait, call and round of a request links to it, each
stage call splits into parts that lie inside it, and a profile opened on
one thread switches the tracer on for the dispatcher threads."""

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu_torch.config import Config
from transtacos_retunegan_tpu_torch.serve.batcher import BatchingFrontend, Coalescer
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
from transtacos_retunegan_tpu_torch.utils import tracing

pytestmark = pytest.mark.usefixtures('few_threads')

# text buckets 16, 16, 32 and 48, so that a round splits into groups
TEXTS = ['ni3 hao3', 'da4 jia1 hao3', 'zhong1 guo2 ren2 min2 hen3 hao3',
         'wo3 men5 dou1 shi4 hao3 peng2 you5 a5 ni3 zhi1 dao4 ma5']
ROWS = 2
STAGES = {'batch-acoustic.call': ('acoustic.text', 'acoustic.launch', 'acoustic.sync'),
          'batch-vocoder.call': ('vocoder.prep', 'vocoder.launch', 'vocoder.sync')}


def small_config() -> Config:
    base = Config()
    return dataclasses.replace(
        base,
        acoustic=dataclasses.replace(
            base.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
            attention_depth=16, prenet_depths=(32,), posnet_depth=64,
            var_embed_depth=16, var_prednet_depth=16, prdsnet_depth=16,
            posenc_depth=8, max_iters=8),
        vocoder=dataclasses.replace(base.vocoder, upsample_initial_channel=16))


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope='module')
def frontend():
    synth = Synthesizer(small_config(), devices=['cpu'])
    fe = BatchingFrontend(synth, max_batch=ROWS, window_s=0.02)
    fe.tts(TEXTS[0])
    return fe


def burst(fe: BatchingFrontend, n: int = 8) -> None:
    with ThreadPoolExecutor(n) as pool:
        wavs = list(pool.map(fe.tts, [TEXTS[i % len(TEXTS)] for i in range(n)]))
    assert len(wavs) == n and all(w.ndim == 1 for w in wavs)


@pytest.fixture(scope='module')
def traced(frontend):
    """The spans of one burst with the tracer on, by id."""
    tracing.clear()
    tracing.enable()
    try:
        burst(frontend)
    finally:
        tracing.disable()
    spans = {s.id: s for s in tracing.spans()}
    tracing.clear()
    return spans


class Clock:
    """Counts the tracer's clock reads."""

    def __init__(self, real):
        self.real, self.reads = real, 0

    def monotonic_ns(self):
        self.reads += 1
        return self.real.monotonic_ns()

    def time_ns(self):
        self.reads += 1
        return self.real.time_ns()


def test_off_stores_nothing_and_reads_no_clock(frontend, monkeypatch):
    clock = Clock(tracing.time)
    monkeypatch.setattr(tracing, 'time', clock)
    co = Coalescer(lambda key, items: [x * 2 for x in items], max_batch=4,
                   window_s=0.01, name='plain')
    with ThreadPoolExecutor(6) as pool:
        assert list(pool.map(lambda i: co(i % 2, i), range(12))) == [2 * i for i in range(12)]
    burst(frontend, 2)
    frontend.synth.synthesize_spec_batch(TEXTS[:2], rows=ROWS)
    assert clock.reads == 0
    assert tracing.spans() == [] and tracing.dropped() == 0 and tracing.anchors() == []
    # what an off site hands back is shared, not made
    f = len
    assert tracing.span('x') is tracing.span('y') and tracing.bind(f) is f
    assert tracing.begin_many('request', 3) == () and tracing.stamp(7) is None
    assert tracing.begin('x') is None


def test_every_span_of_a_request_links_to_it(traced):
    requests = [s for s in traced.values() if s.name == 'request']
    assert len(requests) == 8
    for req in requests:
        waits = sorted((s for s in traced.values()
                        if s.name.endswith('.wait') and s.parent == req.id),
                       key=lambda s: s.start)
        assert [w.name for w in waits] == ['batch-acoustic.wait', 'batch-vocoder.wait']
        for w in waits:
            call = traced[w.attrs['call']]
            rnd = traced[w.attrs['round']]
            assert call.name == w.name.replace('.wait', '.call')
            assert rnd.name == w.name.replace('.wait', '.round')
            assert req.id in call.attrs['requests'] and req.id in rnd.attrs['requests']
            assert call.parent == rnd.id and call.attrs['solo'] == 0
            # a submission waits until its call starts
            assert w.start <= w.end == call.start
            assert req.start <= w.start and call.end <= req.end
        assert waits[0].end < waits[1].start


def test_a_round_runs_one_call_per_group(traced):
    rounds = [s for s in traced.values() if s.name.endswith('.round')]
    assert rounds and any(r.attrs['groups'] > 1 for r in rounds)
    for rnd in rounds:
        calls = [s for s in traced.values() if s.name.endswith('.call') and s.parent == rnd.id]
        assert len(calls) == rnd.attrs['groups']
        assert sum(c.attrs['payloads'] for c in calls) == rnd.attrs['submissions']
        assert all(rnd.start <= c.start for c in calls)


def test_stage_parts_lie_inside_their_call(traced):
    r = small_config().acoustic.outputs_per_step
    for call in (s for s in traced.values() if s.name in STAGES):
        parts = sorted((s for s in traced.values() if s.parent == call.id),
                       key=lambda s: s.start)
        names = [p.name for p in parts]
        assert sorted(set(names)) == sorted(STAGES[call.name]), names
        assert call.start <= parts[0].start and parts[-1].end <= call.end
        for a, b in zip(parts, parts[1:]):
            assert a.end <= b.start, (a, b)
        first = parts[0].attrs
        assert first['rows'] == ROWS and first['real'] == call.attrs['payloads']
        if call.name == 'batch-acoustic.call':
            assert names == list(STAGES[call.name])
            assert first['bucket'] == call.attrs['bucket']
            steps = parts[2].attrs['steps']
            assert len(steps) == ROWS and all(1 <= s <= 8 for s in steps)
        else:
            # the numpy part on the caller, then the copy on the replica
            assert names == ['vocoder.prep', 'vocoder.prep', 'vocoder.launch', 'vocoder.sync']
            assert first['bucket'] == call.attrs['bucket'] == 64
            assert len(first['frames']) == first['real']
            assert all(t % r == 0 and t <= 8 * r for t in first['frames'])


def test_a_profile_switches_the_dispatchers_on():
    co = Coalescer(lambda key, items: [tracing.on() for _ in items], max_batch=1,
                   window_s=0.0, name='probe')
    assert co(0, None) is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert co(0, None) is True
        assert torch.autograd.profiler._is_profiler_enabled
    assert co(0, None) is False
    assert [s.name for s in tracing.spans()] == ['probe.round', 'probe.wait', 'probe.call']
    assert tracing.spans(name='probe.round')[0].attrs['carried'] == 0
    assert len(tracing.anchors()) == 1


def test_a_round_counts_what_it_carried(traced):
    """Every round says how many of its submissions the round before held
    over: here, a bucket of 5 at ``max_batch`` 3 behind a busy dispatcher
    leaves 2, carried with a later submission of another bucket."""
    assert all('carried' in s.attrs for s in traced.values() if s.name.endswith('.round'))
    entered, go = threading.Event(), threading.Event()

    def fn(key, items):
        if key == 'hold':
            entered.set()
            assert go.wait(5)
        elif items == [0, 1, 2]:
            futs.append(co.submit('b', 5))
        return items

    co = Coalescer(fn, max_batch=3, window_s=0.01, name='spill')
    tracing.enable()
    futs = [co.submit('hold', None)]
    assert entered.wait(5)
    futs += [co.submit('a', i) for i in range(5)]
    go.set()
    assert [f.result(timeout=5) for f in futs[:6]] == [None, 0, 1, 2, 3, 4]
    assert futs[6].result(timeout=5) == 5
    rounds = sorted(tracing.spans(name='spill.round'), key=lambda s: s.start)
    assert [(r.attrs['submissions'], r.attrs['groups'], r.attrs['carried'])
            for r in rounds] == [(1, 1, 0), (3, 1, 0), (3, 2, 2)]
    calls = tracing.spans(name='spill.call')
    assert [c.attrs['payloads'] for c in calls if c.parent == rounds[2].id] == [2, 1]
    assert sum(w.attrs['round'] == rounds[2].id for w in tracing.spans(name='spill.wait')) == 3


def test_bind_mark_and_cap(monkeypatch):
    tracing.enable()
    out = {}
    with tracing.span('outer') as outer:
        def work():
            with tracing.span('inner') as inner:
                tracing.mark('launch_ns')
                tracing.mark('launch_ns')
                out['inner'] = inner
        t = threading.Thread(target=tracing.bind(work))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    tracing.mark('alone_ns')                   # no span open: nothing kept
    inner = out['inner']
    assert inner.parent == outer.id and inner.thread != outer.thread
    launches = inner.attrs['launch_ns']
    assert len(launches) == 2 and inner.start <= launches[0] <= launches[1] <= inner.end
    assert 'alone_ns' not in outer.attrs and len(tracing.spans()) == 2
    assert tracing.spans(inner.end, None, 'inner') == [inner]
    assert tracing.spans(None, inner.end - 1, 'inner') == []
    monkeypatch.setattr(tracing, 'CAP', len(tracing.spans()))
    with tracing.span('past the cap'):
        pass
    assert tracing.dropped() == 1 and not tracing.spans(name='past the cap')


def test_replica_spans_link_to_their_call():
    """Under two replicas each replica's parts run on its own thread, as
    children of the call that sent it its rows."""
    two = Synthesizer(small_config(), devices=['cpu', 'cpu'])
    tracing.enable()
    with tracing.span('call') as call:
        specs = two.synthesize_spec_batch(TEXTS[:2], rows=ROWS)
        two.vocode_batch(specs, rows=ROWS)
    parts = [s for s in tracing.spans() if s.name != 'call']
    assert sorted(s.name for s in parts) == sorted(
        ['acoustic.text', 'vocoder.prep'] + ['acoustic.launch', 'acoustic.sync',
                                             'vocoder.prep', 'vocoder.launch',
                                             'vocoder.sync'] * 2)
    assert all(s.parent == call.id for s in parts)
    on_replicas = [s for s in parts if s.name in ('acoustic.launch', 'vocoder.sync')]
    assert len({s.thread for s in on_replicas} - {call.thread}) == 2
    assert all(call.start <= s.start and s.end <= call.end for s in parts)
