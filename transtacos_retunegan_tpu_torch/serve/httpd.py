"""Stdlib HTTP services matching the reference endpoint contract, ported
from ``transtacos_retunegan_tpu/serve/httpd.py``.

Roles gate the routes:

* ``webui`` (port 5103, reference ``app.py``): ``GET /`` demo page,
  ``GET /synth?text=`` -> float32 WAV (text norm + clause packing + neural
  TTS; ``&format=mp3`` through ``ffmpeg`` when it is on PATH, else WAV),
  ``POST /synth_batch`` (JSON ``{"texts": [...], "neural": bool}`` ->
  pickled list of float32 wavs)
* ``acoustic`` (port 5105, reference ``transtacos/server.py``): ``GET /``,
  ``GET /synth?text=`` (Griffin-Lim vocoding), ``POST /synth_spec`` (JSON
  ``{"pinyin": ...}`` -> pickled float32 spec ``[T, F]``)
* ``vocoder`` (port 5104, reference ``retunegan/server.py``):
  ``POST /vocode`` (pickled spec) -> pickled float32 wav
* ``all``: every route above, ``/synth`` neural
* ``GET /healthz`` on every role

Every call that touches the card runs on a long-lived thread: PyTorch builds
some caches per thread (cuDNN's execution plans among them), and a ``tts``
call on a fresh thread took 160-250 ms against 30-40 ms on a long-lived one
on an H100 (``chip_smoke.py``, ``thread_cost``).  Without batching a server
is a one-thread ``HTTPServer`` that answers one request at a time.  With
batching it is a ``ThreadingHTTPServer`` whose handler threads only queue
and wait on a ``batcher.BatchingFrontend``: its two dispatchers coalesce
concurrent requests, and its worker runs the Griffin-Lim surfaces.
"""

from __future__ import annotations

import io
import json
import pickle
import shutil
import subprocess
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
from scipy.io import wavfile

from .batcher import BatchingFrontend
from .pipeline import Synthesizer

ROLES = ('webui', 'acoustic', 'vocoder', 'all')

INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>TransTacoS-RetuneGAN</title></head>
<body>
<h3>Mandarin TTS</h3>
<input id="text" size="60" value="ni3 hao3 shi4 jie4"/>
<button onclick="synth()">Synthesize</button>
<div id="status"></div>
<audio id="player" controls autoplay></audio>
<script>
async function synth() {
  const t = document.getElementById('text').value;
  document.getElementById('status').innerText = 'synthesizing...';
  const r = await fetch('/synth?text=' + encodeURIComponent(t));
  if (!r.ok) { document.getElementById('status').innerText = 'error'; return; }
  const blob = await r.blob();
  document.getElementById('player').src = URL.createObjectURL(blob);
  document.getElementById('status').innerText = 'done';
}
</script>
</body></html>
"""


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav.astype(np.float32))
    return buf.getvalue()


def mp3_bytes(wav: bytes) -> Optional[bytes]:
    """WAV bytes -> MP3 through an ``ffmpeg`` on PATH (reference
    ``app.py:85-90``); None when there is none or it fails, and the caller
    serves the WAV."""
    if shutil.which('ffmpeg') is None:
        return None
    try:
        r = subprocess.run(['ffmpeg', '-i', 'pipe:0', '-f', 'mp3', '-acodec',
                            'libmp3lame', '-loglevel', 'quiet', 'pipe:1'],
                           input=wav, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout if r.returncode == 0 and r.stdout else None


def make_handler(synth: Synthesizer, role: str = 'all',
                 frontend: Optional[BatchingFrontend] = None):
    """Request handler class for ``synth`` in ``role``; with ``frontend``
    the card work of every request runs on the frontend's threads."""
    if role not in ROLES:
        raise ValueError(f'role {role!r}: one of {ROLES}')
    sr = synth.cfg.audio.sample_rate

    def solo(fn, *args):
        return frontend.solo(fn, *args) if frontend is not None else fn(*args)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _synth(self, query):
            txt = unquote(query.get('text', [''])[0]).strip()
            if not txt:
                return self._send(400, b'{"error": "empty request"}',
                                  'application/json')
            # the acoustic role vocodes with Griffin-Lim, the others neurally
            if role == 'acoustic':
                wav = solo(synth.tts, txt, False)
            elif frontend is not None:
                wav = frontend.tts(txt)
            else:
                wav = synth.tts(txt)
            body = wav_bytes(wav, sr)
            if query.get('format', [''])[0] == 'mp3':
                mp3 = mp3_bytes(body)
                if mp3 is not None:
                    return self._send(200, mp3, 'audio/mpeg')
            self._send(200, body, 'audio/wav')

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == '/':
                    self._send(200, INDEX_HTML.encode(), 'text/html; charset=utf-8')
                elif url.path == '/synth' and role != 'vocoder':
                    self._synth(parse_qs(url.query))
                elif url.path == '/healthz':
                    self._send(200, b'ok', 'text/plain')
                else:
                    self._send(404, b'not found', 'text/plain')
            except Exception as e:                       # noqa: BLE001
                self._send(500, json.dumps({'error': repr(e)}).encode(),
                           'application/json')

        def do_POST(self):
            url = urlparse(self.path)
            body = self.rfile.read(int(self.headers.get('Content-Length', 0)))
            try:
                if url.path == '/synth_batch' and role in ('webui', 'all'):
                    payload = json.loads(body)
                    texts, neural = payload['texts'], bool(payload.get('neural', True))
                    if frontend is not None:
                        wavs = frontend.tts_batch(texts, neural)
                    else:
                        wavs = synth.tts_batch(texts, neural)
                    self._send(200, pickle.dumps([w.astype(np.float32) for w in wavs]),
                               'application/octet-stream')
                elif url.path == '/synth_spec' and role in ('acoustic', 'all'):
                    pinyin = json.loads(body)['pinyin']
                    if frontend is not None:
                        spec = frontend.synth_spec(pinyin)
                    else:
                        spec = synth.synthesize_spec(pinyin)      # [F, T]
                    # the reference pickles [T, F] (app.py concatenates on time)
                    self._send(200, pickle.dumps(spec.T.astype(np.float32)),
                               'application/octet-stream')
                elif url.path == '/vocode' and role in ('vocoder', 'all'):
                    spec = np.asarray(pickle.loads(body), np.float32)
                    wav = frontend.vocode(spec) if frontend is not None else synth.vocode(spec)
                    self._send(200, pickle.dumps(wav.astype(np.float32)),
                               'application/octet-stream')
                else:
                    self._send(404, b'not found', 'text/plain')
            except Exception as e:                       # noqa: BLE001
                self._send(500, json.dumps({'error': repr(e)}).encode(),
                           'application/json')

    return Handler


def _start(synth: Synthesizer, role: str, port: int, host: str,
           frontend: Optional[BatchingFrontend]) -> HTTPServer:
    cls = HTTPServer if frontend is None else ThreadingHTTPServer
    server = cls((host, port), make_handler(synth, role, frontend))
    server.role, server.frontend = role, frontend
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def serve(synth: Synthesizer, role: str = 'all', port: int = 5103,
          host: str = '0.0.0.0', batching: bool = False, max_batch: int = 8,
          batch_window_s: float = 0.006) -> HTTPServer:
    """Serve ``role`` from a daemon thread; ``port=0`` picks a free port
    (``server.server_address[1]``); ``server.role`` is ``role`` and
    ``server.frontend`` the batching frontend or None.  Stop it with ``server.shutdown()`` and
    ``server.server_close()``."""
    frontend = (BatchingFrontend(synth, max_batch, batch_window_s)
                if batching else None)
    return _start(synth, role, port, host, frontend)


def serve_all(synth: Optional[Synthesizer] = None, host: str = '0.0.0.0',
              webui_port: int = 5103, vocoder_port: int = 5104,
              acoustic_port: int = 5105, batching: bool = True,
              max_batch: int = 8, batch_window_s: float = 0.006,
              device='cuda') -> List[HTTPServer]:
    """One process, three reference-compatible ports: ``all`` on the WebUI
    port, ``vocoder`` and ``acoustic`` on theirs.  With ``batching`` (the
    default) the three share one frontend, so concurrent requests coalesce
    whichever port they reach."""
    synth = synth or Synthesizer(devices=[device])
    frontend = (BatchingFrontend(synth, max_batch, batch_window_s)
                if batching else None)
    return [_start(synth, role, port, host, frontend)
            for role, port in (('all', webui_port), ('vocoder', vocoder_port),
                               ('acoustic', acoustic_port))]
