"""A/B: the vocoder in float32 against bf16 autocast, on the card.

Port of ``transtacos_retunegan_tpu/tools/bench_precision.py``.  At the
reference batch geometry (B=16, 8192-sample segments) it times

  * the full GAN train step (D x2 + G, ``train/vocoder_step.py``), from
    the JAX package's initial weights for ``PRNGKey(0)``,
  * the B=1 generator forward at the serving length of 400 frames (its
    initial weights from ``PRNGKey(0)``),

for ``compute_dtype`` in {float32, bfloat16} (float32 with TF32 off), and
the bf16-against-float32 deviation of the generator's output on the same
weights and inputs, so that no speed is quoted without its numeric cost.

Each variant: one trial of ``--steps`` calls as a warm-up, then trials of
``--steps`` calls between CUDA events, at least ``--trials`` and more (up
to 10) while the last trial still sets the minimum; the minimum is
reported and each variant's trials are printed to stderr.  ``--device``
defaults to ``cuda`` (raises without a card).  ``main`` returns the JSON
it prints.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.bench_precision [--steps 30] \\
      [--trials 5] [--skip_gan] [--skip_forward] [--only float32|bfloat16] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def _min_of_trials(run_trial, trials: int, tag: str, max_trials: int = 10,
                   rel_tol: float = 0.05) -> float:
    """The minimum over consecutive trials, extended (up to ``max_trials``)
    while the sequence still descends: the last trial sets the minimum, or
    an earlier one lies more than ``rel_tol`` above it."""
    times = [run_trial() for _ in range(trials)]
    while len(times) < max_trials and (
            min(times) == times[-1] or min(times[:-1]) > min(times) * (1 + rel_tol)):
        times.append(run_trial())
    print(f'# {tag} trials ms: ' + ' '.join(f'{t * 1000:.2f}' for t in times),
          file=sys.stderr)
    return min(times)


def _bench_gan(cfg, steps: int, trials: int, tag: str, device) -> float:
    from ..train import vocoder_step as V
    from .acoustic_step_ab import seconds
    from .train_scaling import STEPS_PER_EPOCH, gan_batch
    batch = gan_batch(cfg, cfg.vocoder.batch_size, device)
    state = V.init_gan_state(cfg, 0, device)
    noise = torch.Generator(device=device).manual_seed(0)

    def steps_():
        for _ in range(steps):
            V.gan_train_step(cfg, state, batch, noise, STEPS_PER_EPOCH)

    def trial():
        return seconds(steps_, device) / steps
    trial()                                  # first calls and a warm-up
    return _min_of_trials(trial, trials, tag)


def _bench_forward(cfg, steps: int, trials: int, tag: str, device):
    """B=1 forward at the serving length; returns (seconds, wav)."""
    from .. import jax_random
    from ..models.generators import make_generator
    from ..train.vocoder_step import apply_generator
    from ..weights import flax_vocoder_init
    from .acoustic_step_ab import seconds
    rng = np.random.RandomState(1)
    t_frames = 400
    seg = t_frames * cfg.audio.hop_length
    batch = {'mel': rng.randn(1, t_frames, 80), 'tmpl': rng.randn(1, seg) * 0.1}
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in batch.items()}
    batch['wav'] = batch['tmpl']                     # apply_generator's device
    gen = flax_vocoder_init(make_generator(cfg), jax_random.prng_key(0)).to(device).eval()
    fwd = torch.no_grad()(lambda: apply_generator(cfg, gen, batch))
    wav = fwd().cpu().numpy()

    def calls():
        for _ in range(steps):
            fwd()

    def trial():
        return seconds(calls, device) / steps
    return _min_of_trials(trial, trials, tag), wav


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=30, help='calls per trial')
    p.add_argument('--trials', type=int, default=5,
                   help='consecutive trials, at least; the minimum is reported')
    p.add_argument('--skip_gan', action='store_true')
    p.add_argument('--skip_forward', action='store_true')
    p.add_argument('--only', default=None, choices=['float32', 'bfloat16'],
                   help='bench a single variant')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    from ..config import Config
    from ..serve.pipeline import resolve_device
    from .acoustic_step_ab import true_float32
    from .convergence_session import device_line
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    out = {'device': device_line(device)}
    wavs = {}
    variants = (args.only,) if args.only else ('float32', 'bfloat16')
    with true_float32():
        for name in variants:
            base = Config()
            cfg = dataclasses.replace(base, vocoder=dataclasses.replace(
                base.vocoder, compute_dtype=name))
            if not args.skip_forward:
                fwd_s, wavs[name] = _bench_forward(cfg, args.steps, args.trials,
                                                   f'forward[{name}]', device)
                out[f'forward_ms_{name}'] = round(fwd_s * 1000, 2)
            if not args.skip_gan:
                gan_s = _bench_gan(cfg, args.steps, args.trials, f'gan[{name}]', device)
                out[f'gan_step_ms_{name}'] = round(gan_s * 1000, 2)

    if len(wavs) == 2:
        d = wavs['bfloat16'] - wavs['float32']
        out['forward_dev_max'] = round(float(np.abs(d).max()), 5)
        out['forward_dev_mean'] = round(float(np.abs(d).mean()), 6)
        out['forward_speedup'] = round(
            out['forward_ms_float32'] / out['forward_ms_bfloat16'], 3)
    if 'gan_step_ms_float32' in out and 'gan_step_ms_bfloat16' in out:
        out['gan_speedup'] = round(out['gan_step_ms_float32'] / out['gan_step_ms_bfloat16'], 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
