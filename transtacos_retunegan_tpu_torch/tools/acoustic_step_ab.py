"""The acoustic train step at bench geometry on the card, forward-only
against the full step.

Port of ``transtacos_retunegan_tpu/tools/acoustic_step_ab.py``.  The JAX
tool A/Bs the decode scan's ``unroll`` factor; the port's training decode
is a Python loop over the steps (``models/decoder.py::train_decode``,
whose docstring notes that ``scan_unroll`` has no counterpart there), so
``--unrolls`` takes only ``1`` and refuses any other factor.  What stays:
the scanned ``train_step`` at the reference batch geometry (B16 x T400 x
N32, ``make_batch``: the JAX tool's arrays bit for bit) from the JAX
package's initial weights for ``PRNGKey(5)``, warm-up calls, then the
fastest of ``--trials`` trials of ``--steps`` steps timed by CUDA events;
and the teacher-forced forward with the loss alone (no gradient).  Float32
with TF32 off, as the trainers run.

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
same code on the host clock).  Writes ``--out`` (default under
``runs/torch_port/``) with the card's name and power limit.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.acoustic_step_ab \\
      [--unrolls 1] [--out runs/torch_port/acoustic_step_ab.json] [--tiny] \\
      [--warm 7] [--steps 10] [--trials 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..text.symbols import get_vocab_size

UNROLL_NOTE = ('the training decode is a Python loop over the steps: the JAX '
               "config's scan_unroll has no counterpart there "
               '(transtacos_retunegan_tpu_torch/models/decoder.py, train_decode)')
TINY = dict(embed_depth=32, encoder_depth=32, decoder_depth=64, attention_depth=16,
            prenet_depths=(32,), posnet_depth=64, var_embed_depth=16,
            var_prednet_depth=16, prdsnet_depth=16, posenc_depth=8)


def tiny(cfg: Config) -> Config:
    """The JAX tools' ``--tiny`` acoustic dims."""
    return dataclasses.replace(cfg, acoustic=dataclasses.replace(cfg.acoustic, **TINY))


def make_batch(cfg: Config, b: int = 16, n_txt: int = 32, t: int = 400,
               device='cpu') -> Dict[str, torch.Tensor]:
    """The JAX tool's seeded batch (``RandomState(0)``, the same arrays in
    the same order) as tensors on ``device``."""
    rng = np.random.RandomState(0)
    arrays = {
        'text': np.stack([rng.randint(4, get_vocab_size(), (b, n_txt)),
                          rng.randint(0, 6, (b, n_txt))], -1).astype(np.int32),
        'text_lengths': np.full((b,), n_txt, np.int32),
        'prds': rng.randint(0, 6, (b, n_txt)).astype(np.int32),
        'spec_lengths': np.full((b,), t, np.int32),
        'mel_targets': rng.randn(b, t, 80).astype(np.float32),
        'mag_targets': rng.randn(b, t, 1024).astype(np.float32),
        'f0_targets': rng.randint(0, cfg.audio.n_f0_bins, (b, t)).astype(np.int32),
        'c0_targets': rng.randint(0, 32, (b, t)).astype(np.int32),
        'stop_token_targets': np.zeros((b, t), np.float32),
        'frame_loss_len': np.asarray(t, np.int32),
        'text_loss_len': np.asarray(n_txt, np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@contextlib.contextmanager
def true_float32():
    """TF32 off for matmuls and cuDNN (the location conv) inside, as it was
    after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def seconds(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds ``fn()`` takes: between CUDA events on the card (the work
    queued before it done first), on the host clock on the CPU."""
    if device.type != 'cuda':
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def min_of_trials(call: Callable[[], object], device: torch.device, n_warm: int,
                  n: int, n_trial: int) -> float:
    """Seconds per call: one first call and ``n_warm`` warm-up calls, then
    the fastest of ``n_trial`` trials of ``n`` calls each."""
    for _ in range(1 + n_warm):
        call()

    def trial():
        for _ in range(n):
            call()
    return min(seconds(trial, device) for _ in range(n_trial)) / n


def time_step(cfg: Config, batch, n_warm: int = 7, n: int = 10, n_trial: int = 3,
              step_fn=None, state=None, device=None):
    """Seconds per ``step_fn`` (default: the scanned ``train_step``) from
    ``state`` (default: the JAX package's initial weights for
    ``PRNGKey(5)``); returns (seconds, state)."""
    from ..train import acoustic_step as A
    from ..train.train_acoustic import make_draws
    device = device or batch['text'].device
    step_fn = step_fn or A.train_step
    if state is None:
        state = A.init_state(cfg, 5, device)
    draws = make_draws(0, device)
    best = min_of_trials(lambda: step_fn(cfg, state, batch, draws), device,
                         n_warm, n, n_trial)
    return best, state


def time_forward(cfg: Config, batch, state, n_warm: int = 7, n: int = 10,
                 n_trial: int = 3) -> float:
    """Seconds per teacher-forced forward with the loss, without a
    gradient (the forward/backward split)."""
    from ..models.acoustic import compute_losses
    from ..train.acoustic_step import _forward, frozen_stats
    from ..train.train_acoustic import make_draws
    device = batch['text'].device
    draws = make_draws(0, device)
    model = state.model

    @torch.no_grad()
    def fwd():
        with frozen_stats(model):
            return compute_losses(_forward(model, batch, 1.0, draws), batch, cfg,
                                  model)['loss']
    return min_of_trials(fwd, device, n_warm, n, n_trial)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--unrolls', default='1',
                   help=f'only 1: {UNROLL_NOTE}')
    p.add_argument('--out', default='runs/torch_port/acoustic_step_ab.json')
    p.add_argument('--tiny', action='store_true', default=False,
                   help='tiny dims/geometry (CPU smoke of this script)')
    p.add_argument('--warm', type=int, default=7, help='warm-up calls after the first')
    p.add_argument('--steps', type=int, default=10, help='calls per trial')
    p.add_argument('--trials', type=int, default=3, help='trials; the fastest is kept')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The measurement; returns what it writes to ``--out``."""
    from ..serve.pipeline import resolve_device
    from .convergence_session import device_line
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    unrolls = [int(x) for x in args.unrolls.split(',')]
    if unrolls != [1]:
        raise SystemExit(f'--unrolls {args.unrolls}: only 1 is measured; {UNROLL_NOTE}')
    reps = dict(n_warm=args.warm, n=args.steps, n_trial=args.trials)
    cfg = tiny(Config()) if args.tiny else Config()
    batch = make_batch(cfg, b=2, n_txt=12, t=20, device=device) if args.tiny \
        else make_batch(cfg, device=device)
    with true_float32():
        step_s, state = time_step(cfg, batch, device=device, **reps)
        print(f'# unroll=1: {step_s * 1000:.2f} ms/step', flush=True)
        fwd_ms = round(time_forward(cfg, batch, state, **reps) * 1000, 2)
    print(f'# unroll=1 forward-only: {fwd_ms} ms', flush=True)
    b_, t_ = batch['prds'].shape[0], batch['mel_targets'].shape[1]
    result = {'device': device_line(device),
              'geometry': f"bs{b_} x T{t_} x N{batch['prds'].shape[1]}"
                          + (' (tiny smoke)' if args.tiny else ' (bench geometry)'),
              'forward_only_ms_at_unroll1': fwd_ms,
              'by_unroll': {'1': {'step_ms': round(step_s * 1000, 2)}}}
    write_json(args.out, result)
    return result


def write_json(path: str, result: dict, indent: Optional[int] = 2) -> None:
    """``result`` to ``path`` (its folder made) and to stdout on one line."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(result, fh, indent=indent)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
