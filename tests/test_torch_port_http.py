"""HTTP contract of the port's handler (CPU device, ephemeral port),
mirroring ``tests/test_serving.py``'s TestHTTP."""

import json
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import cfg_pair
from transtacos_retunegan_tpu_torch.serve.httpd import serve
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer

pytestmark = pytest.mark.usefixtures('few_threads')

_, PCFG = cfg_pair()


@pytest.fixture(scope='module')
def synth():
    return Synthesizer(PCFG, devices=['cpu'])


@pytest.fixture(scope='module')
def url(synth):
    server = serve(synth, port=0, host='127.0.0.1')
    yield f'http://127.0.0.1:{server.server_address[1]}'
    server.shutdown()
    server.server_close()


def test_index_page(url):
    assert b'<html' in urllib.request.urlopen(url + '/').read().lower()


def test_synth_returns_float32_wav(url):
    from scipy.io import wavfile
    import io
    r = urllib.request.urlopen(url + '/synth?text=ni3%20hao3', timeout=120)
    body = r.read()
    assert body[:4] == b'RIFF' and r.headers['Content-Type'] == 'audio/wav'
    sr, wav = wavfile.read(io.BytesIO(body))
    assert sr == 22050 and wav.dtype == np.float32 and len(wav) > 0


def test_synth_spec_pickle_contract(url):
    req = urllib.request.Request(url + '/synth_spec',
                                 data=json.dumps({'pinyin': 'ni3 hao3'}).encode(),
                                 headers={'Content-Type': 'application/json'})
    spec = pickle.loads(urllib.request.urlopen(req, timeout=120).read())
    assert spec.dtype == np.float32 and spec.shape[1] == 1025     # [T, F]


def test_vocode_pickle_contract(url):
    spec = np.abs(np.random.RandomState(0).randn(40, 1025) * 0.01).astype(np.float32)
    req = urllib.request.Request(url + '/vocode', data=pickle.dumps(spec))
    wav = pickle.loads(urllib.request.urlopen(req, timeout=120).read())
    assert wav.dtype == np.float32 and len(wav) == 40 * 256


def test_empty_text_400(url):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + '/synth?text=', timeout=60)
    assert e.value.code == 400


def test_unknown_route_404(url):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + '/synth_batch', timeout=60)
    assert e.value.code == 404


def test_requests_share_one_worker_thread(url, synth, monkeypatch):
    """Every request's work runs on the server's one long-lived thread, not
    on a thread of its own."""
    threads = []
    tts = synth.tts
    monkeypatch.setattr(synth, 'tts', lambda text: threads.append(
        threading.get_ident()) or tts(text))
    for _ in range(2):
        urllib.request.urlopen(url + '/synth?text=a1', timeout=120).read()
    assert len(threads) == 2 and threads[0] == threads[1]
    assert threads[0] != threading.get_ident()
