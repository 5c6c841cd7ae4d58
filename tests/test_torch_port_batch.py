"""The batched serving path of the port against the JAX package: the
``Synthesizer``'s batched and Griffin-Lim surfaces (CPU; the decode runs the
plain version of ``decode_full``) against the JAX ``Synthesizer(
fused_decoder=True)`` (Pallas in interpret mode) on the same weights, with
each request's JAX phase passed to the port; ``trim_silence`` against the
JAX function; the ``Coalescer`` and ``BatchingFrontend`` as
``tests/test_serving_concurrent.py`` holds the JAX ones; the three-role HTTP
contract; the CLI.

Tolerances, and why:

* specs: 1e-3 relative and 1e-4 absolute, ``test_serving.py``'s bound for
  a batched spec against a single one.  Both decodes use bf16 weights on the
  same operands, but the frameworks sum in other orders, which the
  autoregression carries, and the natural scale exponentiates.
* neural wavs: 1e-4 absolute on a wav in [-1, 1], as the slice test: the
  same differences, through the 4-iteration template and the generator.
* Griffin-Lim wavs: 1e-4 of the wav's peak, as ``test_torch_port_dsp``
  holds the port's Griffin-Lim (FFT here, DFT matmuls there, float32).
* concurrent against serial through the batching frontend (port only):
  bit-identical.  Both stages run every cohort at ``max_batch`` rows and
  the phase is seeded from the request's text, so a request's arithmetic
  does not depend on its cohort.
"""

import io
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair, distinct_stop_bias, jax_synthesizer, np_tree
from transtacos_retunegan_tpu.audio import features as jfeatures
from transtacos_retunegan_tpu_torch.audio import features as pfeatures
from transtacos_retunegan_tpu_torch.ops import fused_decoder as PF
from transtacos_retunegan_tpu_torch.serve import app, httpd
from transtacos_retunegan_tpu_torch.serve.batcher import BatchingFrontend, Coalescer
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer

pytestmark = pytest.mark.usefixtures('few_threads')

JCFG, PCFG = cfg_pair()
TEXTS = ['ni3 hao3 shi4 jie4', 'da4 jia1 hao3', 'zhong1 guo2']     # one text bucket
STOP_GAIN = 30.0     # the init's stop logits differ by ~0.01 between steps


def _set_stop(jsynth, port, bias, gain):
    """Stop head of both sides: kernel times ``gain``, every bias ``bias``."""
    stop = jsynth.acoustic_params['decoder_cell']['stop_projection']
    stop['kernel'] = stop['kernel'] * gain
    stop['bias'] = jnp.full_like(stop['bias'], bias)
    cell = port.acoustic.decoder_cell
    with torch.no_grad():
        cell.stop_projection.weight.mul_(gain)
        cell.stop_projection.bias.fill_(bias)
    port.decoder = PF.fold_params(cell, port.decoder.wbuf.dtype)


@pytest.fixture(scope='module')
def pair():
    """The shared JAX synthesizer and the port on its weights, with a stop
    head under which the rows of ``TEXTS`` stop at different steps; the JAX
    stop head is restored afterwards."""
    jsynth = jax_synthesizer()
    stop = jsynth.acoustic_params['decoder_cell']['stop_projection']
    saved = dict(stop)
    port = Synthesizer(PCFG, acoustic_params=np_tree(jsynth.acoustic_params),
                       gen_params=np_tree(jsynth.gen_params), devices=['cpu'])
    _set_stop(jsynth, port, -20.0, STOP_GAIN)
    enc = port._encode_batch(TEXTS)
    out = PF.to_outputs(port.decoder, *PF.decode_full_plain(
        port.decoder, enc['keys'], enc['values'], enc['mask'], port.max_iters))
    bias, steps = distinct_stop_bias(out['stop_token_outputs'][:len(TEXTS)].numpy(),
                                     PCFG.acoustic.outputs_per_step, -20.0)
    _set_stop(jsynth, port, bias, 1.0)
    yield jsynth, port, steps
    stop.update(saved)


def _phase(key, shape):
    return np.array(2.0 * jnp.pi * jax.random.uniform(key, shape))


def _keys(n, seed=0):
    return [jax.random.PRNGKey(seed + i) for i in range(n)]


def test_spec_batch_rows_stop_at_their_own_steps(pair):
    jsynth, port, steps = pair
    got = port.synthesize_spec_batch(TEXTS)
    ref = jsynth.synthesize_spec_batch(TEXTS)
    r = PCFG.acoustic.outputs_per_step
    assert [s.shape[1] for s in got] == list(steps * r), steps
    assert len(set(steps.tolist())) == len(TEXTS)
    for g, s in zip(got, ref):
        assert g.shape == s.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, s, rtol=1e-3, atol=1e-4)
    # a row alone: same length, same spec
    alone = port.synthesize_spec(TEXTS[1])
    np.testing.assert_allclose(alone, got[1], rtol=1e-3, atol=1e-4)


def test_vocode_batch_matches_jax(pair):
    jsynth, port, _ = pair
    rng = np.random.RandomState(0)
    specs = [np.abs(rng.randn(JCFG.audio.n_freq, t) * 0.01).astype(np.float32)
             for t in (20, 45, 33)]
    keys = _keys(3)
    ref = jsynth.vocode_batch(specs, keys=keys)
    got = port.vocode_batch([s.T for s in specs],                    # [T, F] too
                            thetas=[_phase(k, (JCFG.audio.n_freq, 64)) for k in keys])
    for g, s, spec in zip(got, ref, specs):
        assert g.shape == s.shape == (256 * spec.shape[1],)
        np.testing.assert_allclose(g, s, atol=1e-4)


def test_tts_batch_neural_matches_jax(pair):
    jsynth, port, _ = pair
    keys = _keys(3, seed=10)
    ref = jsynth.tts_batch(TEXTS, neural=True, keys=keys)
    got = port.tts_batch(TEXTS, thetas=[_phase(k, (JCFG.audio.n_freq, 64)) for k in keys])
    for g, s in zip(got, ref):
        assert g.shape == s.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, s, atol=1e-4)


def _gl_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_griffin_lim_surfaces_match_jax(pair, monkeypatch):
    """``synthesize_wav`` (64-frame bucket), ``tts(neural=False)`` (no
    bucket) and ``tts_batch(neural=False)`` with the JAX request's phase."""
    jsynth, port, steps = pair
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(jsynth, '_next_key', lambda: key)
    n_freq, r = JCFG.audio.n_freq, PCFG.acoustic.outputs_per_step
    _gl_close(port.synthesize_wav(TEXTS[0], theta=torch.tensor(_phase(key, (n_freq, 64)))),
              jsynth.synthesize_wav(TEXTS[0]))
    t = int(steps[0]) * r
    _gl_close(port.tts(TEXTS[0], neural=False,
                       theta=torch.tensor(_phase(key, (n_freq, t)))),
              jsynth.tts(TEXTS[0], neural=False))
    got = port.tts_batch(TEXTS[:2], neural=False,
                         thetas=[torch.tensor(_phase(key, (n_freq, 64)))] * 2)
    for g, s in zip(got, jsynth.tts_batch(TEXTS[:2], neural=False)):
        _gl_close(g, s)


def test_synthesize_with_alignment(pair):
    _, port, steps = pair
    out = port.synthesize_with_alignment(TEXTS[2])
    r = PCFG.acoustic.outputs_per_step
    n = 8                                           # 'zhong1 guo2' serialises to 8 ids
    assert out['n_frames'] == steps[2] * r and out['spec'].shape == (1025, steps[2] * r)
    assert out['alignment'].shape == (n, steps[2])
    np.testing.assert_allclose(out['alignment'].sum(0), 1.0, atol=1e-5)


@pytest.mark.parametrize('case', ['speech', 'quiet-edges', 'silent', 'short'])
def test_trim_silence_matches_jax(case):
    rng = np.random.RandomState(4)
    t = np.arange(22050) / 22050.0
    y = {'speech': (0.5 * np.sin(2 * np.pi * 220 * t) * (t > 0.2) * (t < 0.7)
                    + 1e-4 * rng.randn(len(t))),
         'quiet-edges': np.concatenate([1e-5 * rng.randn(3000), rng.randn(5000),
                                        1e-6 * rng.randn(2000)]),
         'silent': np.zeros(4000),
         'short': rng.randn(300)}[case].astype(np.float32)
    got = pfeatures.trim_silence(y, PCFG.audio)
    np.testing.assert_array_equal(got, jfeatures.trim_silence(y, JCFG.audio))
    assert len(got) <= len(y)


# ---------------------------------------------------------------------------
# Coalescer (test_serving_concurrent.py's TestCoalescer, on the port's class)
# ---------------------------------------------------------------------------

def test_coalescer_groups_same_bucket():
    batches = []

    def fn(bucket, payloads):
        batches.append((bucket, list(payloads)))
        time.sleep(0.01)                  # hold the dispatcher: the next wave queues
        return [p * 10 for p in payloads]

    co = Coalescer(fn, max_batch=8, window_s=0.05)
    with ThreadPoolExecutor(8) as ex:
        results = list(ex.map(lambda i: co('b', i), range(8)))
    assert sorted(results) == [i * 10 for i in range(8)]
    assert any(len(p) > 1 for _, p in batches), batches


def test_coalescer_buckets_never_mix():
    batches = []

    def fn(bucket, payloads):
        batches.append((bucket, list(payloads)))
        return payloads

    co = Coalescer(fn, max_batch=4, window_s=0.05)
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: co(i % 2, i), range(24)))
    for bucket, payloads in batches:
        assert all(p % 2 == bucket for p in payloads)
        assert 1 <= len(payloads) <= 4
    assert sorted(p for _, ps in batches for p in ps) == list(range(24))


@pytest.mark.parametrize('max_batch, keys, late, calls', [
    (8, [i % 3 for i in range(15)], None,
     [[0, 3, 6, 9, 12], [1, 4, 7, 10, 13], [2, 5, 8, 11, 14]]),
    (4, [0] * 10, 0, [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]),
], ids=['three-buckets-of-5', 'one-bucket-of-11'])
def test_a_round_fills_each_bucket(max_batch, keys, late, calls):
    """Submissions queued behind a busy dispatcher: each bucket's call
    takes up to ``max_batch`` of them, in arrival order, and what a full
    bucket cannot take goes ahead of a later submission of its bucket
    (``late``, queued while the first call runs)."""
    entered, go = threading.Event(), threading.Event()
    seen, later = [], []

    def fn(bucket, payloads):
        if bucket == 'hold':
            entered.set()
            assert go.wait(5)
        else:
            seen.append(list(payloads))
            if late is not None and len(seen) == 1:
                later.append(co.submit(late, len(keys)))
        return payloads

    co = Coalescer(fn, max_batch=max_batch, window_s=0.01)
    futs = [co.submit('hold', 'h')]
    assert entered.wait(5)
    futs += [co.submit(k, i) for i, k in enumerate(keys)]
    go.set()
    assert [f.result(timeout=5) for f in futs] == ['h'] + list(range(len(keys)))
    assert [f.result(timeout=5) for f in later] == ([] if late is None else [len(keys)])
    assert seen == calls


def test_coalescer_exception_reaches_the_waiter_and_dispatcher_survives():
    calls = []

    def fn(bucket, payloads):
        calls.append(payloads)
        if len(calls) == 1:
            raise RuntimeError('boom')
        return payloads

    co = Coalescer(fn, max_batch=4, window_s=0.01)
    with pytest.raises(RuntimeError, match='boom'):
        co('b', 1)
    assert co('b', 7) == 7


def test_coalescer_result_count_mismatch_raises():
    co = Coalescer(lambda b, p: [1, 2, 3], max_batch=4, window_s=0.01)
    with pytest.raises(RuntimeError, match='results'):
        co('b', 0)


def test_coalescer_poisoned_request_does_not_fail_its_cohort():
    calls = []

    def fn(bucket, payloads):
        calls.append(list(payloads))
        if 'poison' in payloads:
            raise ValueError('bad payload')
        time.sleep(0.01)
        return [p.upper() for p in payloads]

    co = Coalescer(fn, max_batch=8, window_s=0.08)

    def req(p):
        try:
            return co('b', p)
        except ValueError as e:
            return f'ERR:{e}'

    payloads = ['a', 'b', 'poison', 'c', 'd', 'e']
    with ThreadPoolExecutor(6) as ex:
        results = dict(zip(payloads, ex.map(req, payloads)))
    assert results['poison'] == 'ERR:bad payload'
    assert all(results[p] == p.upper() for p in 'abcde'), results
    assert any('poison' in c and len(c) > 1 for c in calls), calls
    assert co('b', 'z') == 'Z'


# ---------------------------------------------------------------------------
# BatchingFrontend and HTTP (port only, on its own seeded weights)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def synth():
    return Synthesizer(PCFG, devices=['cpu'])


def test_frontend_vocode_concurrent_equals_serial(synth):
    rng = np.random.RandomState(0)
    specs = [np.abs(rng.randn(1025, 20 + 3 * i) * 0.01).astype(np.float32)
             for i in range(4)]                          # one 64-frame bucket
    fe = BatchingFrontend(synth, max_batch=4, window_s=0.2)
    with ThreadPoolExecutor(4) as ex:
        conc = list(ex.map(fe.vocode, specs))
    serial = [fe.vocode(s) for s in specs]
    for c, s in zip(conc, serial):
        assert c.shape == s.shape
        np.testing.assert_array_equal(c, s)


def test_fixed_rows_make_a_spec_independent_of_its_cohort(synth):
    """At a fixed row count a text's spec is bit-identical alone and in any
    cohort (the encoder's kernels are chosen by shape, the decode runs each
    row on its own).  The batching frontend runs every acoustic cohort at
    max_batch rows, so concurrent specs equal serial ones exactly."""
    texts = ['ni3 hao3 shi4 jie4', 'da4 jia1 hao3', 'ma1 ma5', 'a1']
    cohort = synth.synthesize_spec_batch(texts, rows=4)
    for text, spec in zip(texts, cohort):
        np.testing.assert_array_equal(synth.synthesize_spec_batch([text], rows=4)[0], spec)
    fe = BatchingFrontend(synth, max_batch=4, window_s=0.2)
    with ThreadPoolExecutor(4) as ex:
        conc = list(ex.map(fe.synth_spec, texts))
    for c, spec, text in zip(conc, cohort, texts):
        np.testing.assert_array_equal(c, spec)
        np.testing.assert_array_equal(fe.synth_spec(text), spec)


def test_frontend_tts_concurrent_equals_serial_and_batch(synth):
    texts = ['ni3 hao3', 'da4 jia1 hao3', 'ma1 ma5', 'shi4 jie4']
    fe = BatchingFrontend(synth, max_batch=4, window_s=0.2)
    with ThreadPoolExecutor(4) as ex:
        conc = list(ex.map(fe.tts, texts))
    serial = [fe.tts(t) for t in texts]
    batch = fe.tts_batch(texts)
    for c, s, b in zip(conc, serial, batch):
        assert c.shape == s.shape == b.shape
        np.testing.assert_array_equal(c, s)
        np.testing.assert_array_equal(b, s)


def test_frontend_runs_card_work_on_its_own_threads(synth, monkeypatch):
    """Handlers only wait: the decode runs on the acoustic dispatcher, the
    generator on the vocoder dispatcher, Griffin-Lim on the worker."""
    seen = {}
    for name in ('synthesize_spec_batch', 'vocode_batch', 'tts_batch'):
        fn = getattr(synth, name)
        monkeypatch.setattr(synth, name, lambda *a, _f=fn, _n=name, **k: seen.setdefault(
            _n, threading.current_thread().name) and _f(*a, **k))
    fe = BatchingFrontend(synth, max_batch=2, window_s=0.01)
    fe.tts('ni3 hao3')
    fe.tts_batch(['a1'], neural=False)
    assert seen == {'synthesize_spec_batch': 'batch-acoustic',
                    'vocode_batch': 'batch-vocoder', 'tts_batch': 'batch-worker'}


@pytest.fixture(scope='module')
def ports(synth):
    servers = httpd.serve_all(synth, host='127.0.0.1', webui_port=0, vocoder_port=0,
                              acoustic_port=0, batching=True, max_batch=4,
                              batch_window_s=0.05)
    yield {s.role: s.server_address[1] for s in servers}
    for s in servers:
        s.shutdown()
        s.server_close()


def _get(port, path, timeout=120):
    return urllib.request.urlopen(f'http://127.0.0.1:{port}{path}', timeout=timeout)


def _post(port, path, data, timeout=120):
    return urllib.request.urlopen(urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=data), timeout=timeout)


def _status(fn, *args):
    try:
        return fn(*args).status
    except urllib.error.HTTPError as e:
        return e.code


def test_roles_gate_the_routes(ports):
    spec = pickle.dumps(np.abs(np.random.RandomState(0).randn(40, 1025) * 0.01
                               ).astype(np.float32))
    text = json.dumps({'pinyin': 'ni3 hao3'}).encode()
    batch = json.dumps({'texts': ['ni3 hao3', 'a1']}).encode()
    routes = {'/synth': lambda p: _status(_get, p, '/synth?text=a1'),
              '/synth_spec': lambda p: _status(_post, p, '/synth_spec', text),
              '/vocode': lambda p: _status(_post, p, '/vocode', spec),
              '/synth_batch': lambda p: _status(_post, p, '/synth_batch', batch),
              '/healthz': lambda p: _status(_get, p, '/healthz')}
    want = {'all': {'/synth', '/synth_spec', '/vocode', '/synth_batch', '/healthz'},
            'acoustic': {'/synth', '/synth_spec', '/healthz'},
            'vocoder': {'/vocode', '/healthz'}}
    for role, port in ports.items():
        got = {route for route, call in routes.items() if call(port) == 200}
        assert got == want[role], role


def test_synth_wav_neural_and_griffin_lim(ports):
    for role in ('all', 'acoustic'):
        r = _get(ports[role], '/synth?text=ni3%20hao3')
        assert r.headers['Content-Type'] == 'audio/wav'
        sr, wav = wavfile.read(io.BytesIO(r.read()))
        assert sr == 22050 and wav.dtype == np.float32 and len(wav) > 0
        assert np.isfinite(wav).all()


def test_synth_batch_contract(ports):
    """Neural and Griffin-Lim batches; a neural batch's wavs are what
    ``/synth`` gives for each text."""
    texts = ['ni3 hao3', 'da4 jia1']
    wavs = {}
    for neural in (True, False):
        body = json.dumps({'texts': texts, 'neural': neural}).encode()
        wavs[neural] = pickle.loads(_post(ports['all'], '/synth_batch', body).read())
        assert len(wavs[neural]) == 2
        assert all(w.dtype == np.float32 and len(w) > 0 for w in wavs[neural])
    for t, w in zip(texts, wavs[True]):
        body = _get(ports['all'], '/synth?text=' + t.replace(' ', '%20')).read()
        np.testing.assert_array_equal(w, wavfile.read(io.BytesIO(body))[1])


def test_spec_and_vocode_pickle_contract(ports):
    spec = pickle.loads(_post(ports['acoustic'], '/synth_spec',
                              json.dumps({'pinyin': 'ni3 hao3'}).encode()).read())
    assert spec.dtype == np.float32 and spec.shape[1] == 1025           # [T, F]
    wav = pickle.loads(_post(ports['vocoder'], '/vocode', pickle.dumps(spec)).read())
    assert wav.dtype == np.float32 and len(wav) == 256 * spec.shape[0]


def test_mp3_through_ffmpeg_or_wav(ports, tmp_path, monkeypatch):
    stub = tmp_path / 'ffmpeg'
    stub.write_text('#!/bin/sh\ncat > /dev/null\nprintf "ID3FAKE"\n')
    os.chmod(stub, 0o755)
    monkeypatch.setenv('PATH', f"{tmp_path}:{os.environ['PATH']}")
    r = _get(ports['all'], '/synth?text=ni3%20hao3&format=mp3')
    assert r.headers['Content-Type'] == 'audio/mpeg' and r.read() == b'ID3FAKE'
    monkeypatch.setattr(httpd.shutil, 'which', lambda name: None)
    r = _get(ports['all'], '/synth?text=ni3%20hao3&format=mp3')
    assert r.headers['Content-Type'] == 'audio/wav' and r.read()[:4] == b'RIFF'


def test_cli_starts_a_warmed_batching_server(tmp_path, monkeypatch):
    PCFG.save(str(tmp_path))
    warmed, warm_up = [], BatchingFrontend.warm_up
    monkeypatch.setattr(BatchingFrontend, 'warm_up',
                        lambda self, text: warmed.append(text) or warm_up(self, text))
    servers = app.start(app.parse_args(
        ['--mode', 'webui', '--port', '0', '--host', '127.0.0.1', '--device', 'cpu',
         '--config', str(tmp_path), '--batch_window_ms', '5']))
    try:
        (server,) = servers
        assert server.role == 'webui' and server.frontend is not None and warmed
        assert _get(server.server_address[1], '/synth?text=a1').status == 200
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(SystemExit, match='dp'):
        app.start(app.parse_args(['--dp', '2']))     # more replicas than cards
