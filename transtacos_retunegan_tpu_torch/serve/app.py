"""Serving CLI of the port, after ``transtacos_retunegan_tpu/serve/app.py``.

    python -m transtacos_retunegan_tpu_torch.serve.app \\
        --acoustic_dir runs/acoustic --vocoder_dir runs/vocoder [--mode all]

Modes: ``all`` (default: one process, three reference-compatible ports 5103
webui, 5104 vocoder, 5105 acoustic) or one role on its reference port (or
``--port``).  Weights come from the trainers' run dirs (the newest
``ckpt_`` / ``g_``; a dir without one keeps the initial weights, as in the
JAX package) or from flax parameter trees saved as ``.npz``
(``--acoustic_npz``/``--vocoder_npz``, ``weights.save_npz``), one source per
model; without either, the JAX server's initial weights.  ``--config``
is given explicitly (a run dir is fine), as in the JAX package.
Micro-batching is on unless ``--batch_window_ms 0``.  Runs on the card
(``--device cuda``) unless told otherwise; ``--dp N`` serves the batched
surfaces from N replicas, one per card (``cuda:0`` .. ``cuda:N-1``).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from ..config import Config
from .httpd import serve, serve_all
from .pipeline import Synthesizer

PORTS = {'webui': 5103, 'vocoder': 5104, 'acoustic': 5105}
WARM_TEXT = 'ni3 hao3'


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--mode', default='all', choices=['all', *PORTS])
    p.add_argument('--host', default='0.0.0.0')
    p.add_argument('--port', type=int, default=None,
                   help='port of a single-role mode (default: its reference port)')
    p.add_argument('--config', default=None, help='config.json, its run dir, or a preset')
    p.add_argument('--acoustic_dir', default=None, help='acoustic run dir (newest ckpt_)')
    p.add_argument('--vocoder_dir', default=None, help='vocoder run dir (newest g_)')
    p.add_argument('--acoustic_npz', default=None)
    p.add_argument('--vocoder_npz', default=None)
    p.add_argument('--kanji_table', default=None)
    p.add_argument('--max_iters', type=int, default=None)
    p.add_argument('--dp', type=int, default=1,
                   help='data-parallel serving: the batched surfaces split their '
                        'rows over N replicas, one per card')
    p.add_argument('--max_batch', type=int, default=8,
                   help='dynamic micro-batching: largest coalesced batch')
    p.add_argument('--batch_window_ms', type=float, default=6.0,
                   help='micro-batching window; 0 serves one request at a time')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    for model in ('acoustic', 'vocoder'):
        if getattr(args, f'{model}_dir') and getattr(args, f'{model}_npz'):
            p.error(f'--{model}_dir and --{model}_npz both give the {model} weights; '
                    'pass one')
    return args


def start(args: argparse.Namespace) -> List:
    """Build the synthesizer, start the servers and warm up every thread
    that will touch the card; returns the servers."""
    devices = [args.device] * args.dp
    if torch.device(args.device).type == 'cuda' and args.dp > 1:
        have = torch.cuda.device_count()
        if have < args.dp:
            raise SystemExit(f'--dp {args.dp} but only {have} CUDA devices')
        devices = [f'cuda:{i}' for i in range(args.dp)]
    cfg = Config.load(args.config) if args.config else Config()
    synth = Synthesizer(cfg, acoustic_params=args.acoustic_npz,
                        gen_params=args.vocoder_npz, kanji_table=args.kanji_table,
                        max_iters=args.max_iters, devices=devices,
                        acoustic_dir=args.acoustic_dir, vocoder_dir=args.vocoder_dir)
    batching = args.batch_window_ms > 0
    kw = dict(batching=batching, max_batch=args.max_batch,
              batch_window_s=args.batch_window_ms / 1000.0)
    t0 = time.time()
    synth.tts(WARM_TEXT)
    if args.dp > 1:
        synth.tts_batch([WARM_TEXT])        # each replica's thread
    if args.mode == 'all':
        servers = serve_all(synth, args.host, **kw)
    else:
        servers = [serve(synth, args.mode, args.port or PORTS[args.mode],
                         args.host, **kw)]
    if batching:
        servers[0].frontend.warm_up(WARM_TEXT)
    print(f'warm-up took {time.time() - t0:.1f} s', flush=True)
    return servers


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    servers = start(args)
    print(', '.join(f'{s.role} on port {s.server_address[1]}'
                    for s in servers)
          + (f' [micro-batching <= {args.max_batch} @ {args.batch_window_ms:g} ms]'
             if args.batch_window_ms > 0 else ''), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


if __name__ == '__main__':
    main()
