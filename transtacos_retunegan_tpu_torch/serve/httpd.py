"""Stdlib HTTP front end, ported from ``transtacos_retunegan_tpu/serve/httpd.py``
for the all-in-one role:

* ``GET /``                -> demo page
* ``GET /synth?text=``     -> float32 WAV (text norm + clause packing +
  neural TTS)
* ``POST /synth_spec``     -> JSON ``{"pinyin": ...}`` in, pickled float32
  spec ``[T, F]`` out (the reference acoustic service's payload)
* ``POST /vocode``         -> pickled spec in, pickled float32 wav out
* ``GET /healthz``

Requests are served one at a time on the server's one long-lived thread:
PyTorch builds some caches per thread (cuDNN's execution plans among them),
and a ``tts`` call on a fresh thread took 160-250 ms against 30-40 ms on a
long-lived one on an H100 (``chip_smoke.py``, ``thread_cost``), so a thread
per request would pay that on every request.
"""

from __future__ import annotations

import io
import json
import pickle
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
from scipy.io import wavfile

from .pipeline import Synthesizer

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


def make_handler(synth: Synthesizer):
    """Request handler class for ``synth``."""
    sr = synth.cfg.audio.sample_rate

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == '/':
                    self._send(200, INDEX_HTML.encode(), 'text/html; charset=utf-8')
                elif url.path == '/synth':
                    q = parse_qs(url.query)
                    txt = unquote(q.get('text', [''])[0]).strip()
                    if not txt:
                        return self._send(400, b'{"error": "empty request"}',
                                          'application/json')
                    wav = synth.tts(txt)
                    self._send(200, wav_bytes(wav, sr), 'audio/wav')
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
                if url.path == '/synth_spec':
                    pinyin = json.loads(body)['pinyin']
                    spec = synth.synthesize_spec(pinyin)      # [F, T]
                    self._send(200, pickle.dumps(spec.T.astype(np.float32)),
                               'application/octet-stream')
                elif url.path == '/vocode':
                    spec = np.asarray(pickle.loads(body), np.float32)
                    wav = synth.vocode(spec)
                    self._send(200, pickle.dumps(wav.astype(np.float32)),
                               'application/octet-stream')
                else:
                    self._send(404, b'not found', 'text/plain')
            except Exception as e:                       # noqa: BLE001
                self._send(500, json.dumps({'error': repr(e)}).encode(),
                           'application/json')

    return Handler


def serve(synth: Synthesizer, port: int = 5103,
          host: str = '0.0.0.0') -> HTTPServer:
    """Start the server in a daemon thread; ``port=0`` picks a free port
    (``server.server_address[1]``).  Stop it with ``server.shutdown()``
    and ``server.server_close()``."""
    server = HTTPServer((host, port), make_handler(synth))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def serve_all(synth: Optional[Synthesizer] = None, host: str = '0.0.0.0',
              port: int = 5103, device='cuda') -> HTTPServer:
    """All endpoints on one port (the reference WebUI port by default)."""
    return serve(synth or Synthesizer(device=device), port, host)
