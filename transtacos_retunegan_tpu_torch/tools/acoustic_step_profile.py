"""Where an acoustic train step's time goes on the card.

torch.profiler over a few steps of ``train_step_hoisted`` (the step before
the teacher-forcing decay) or ``train_step`` (after it) at the default
``Config()``, seeded weights and a seeded batch of B=16 utterances of
``--frames`` frames and ``--text`` text positions, after a warm-up: the
steps timed by CUDA events without the profiler, then the same number
under it: the kernels by device time, the kernel launches per step, and
the device's busy share: the kernels' time over the step time.

    python -m transtacos_retunegan_tpu_torch.tools.acoustic_step_profile \\
        [--step hoisted|scanned] [--steps 3] [--frames 400] [--text 64] [--top 15]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import Config
from ..train import acoustic_step as A
from ..train.train_acoustic import make_draws


def _self_device_us(event) -> float:
    return float(getattr(event, 'self_device_time_total', None)
                 or getattr(event, 'self_cuda_time_total', 0) or 0)


def seeded_batch(cfg: Config, b: int, frames: int, n_text: int, seed: int = 0,
                 device='cuda'):
    """A batch with the feeder's layout: text of 3/4 to all of ``n_text``
    positions per row, spectrograms of 3/4 to all of ``frames`` frames
    (padded to the frame bucket), stop targets 1 past each length."""
    au, hp = cfg.audio, cfg.acoustic
    r = np.random.RandomState(seed)
    t_pad = -(-(frames + 1) // hp.frame_bucket) * hp.frame_bucket
    tl = r.randint(3 * n_text // 4, n_text + 1, b)
    sl = r.randint(3 * frames // 4, frames + 1, b)
    tl[0], sl[0] = n_text, frames
    text = np.zeros((b, n_text, 2), np.int32)
    stop = np.ones((b, t_pad), np.float32)
    for i in range(b):
        text[i, :tl[i], 0] = r.randint(1, 40, tl[i])
        text[i, :tl[i], 1] = r.randint(0, au.n_tone, tl[i])
        stop[i, :sl[i]] = 0.0
    arrays = {'text': text, 'text_lengths': tl.astype(np.int32),
              'prds': r.randint(0, au.n_prds, (b, n_text)).astype(np.int32),
              'spec_lengths': sl.astype(np.int32),
              'mel_targets': r.randn(b, t_pad, au.n_mel).astype(np.float32),
              'mag_targets': r.randn(b, t_pad, au.n_freq - 1).astype(np.float32),
              'f0_targets': r.randint(0, au.n_f0_bins, (b, t_pad)).astype(np.int32),
              'c0_targets': r.randint(0, au.n_c0_bins, (b, t_pad)).astype(np.int32),
              'stop_token_targets': stop,
              'frame_loss_len': np.asarray(-(-(frames + 1) // hp.outputs_per_step)
                                           * hp.outputs_per_step, np.int32),
              'text_loss_len': np.asarray(n_text, np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def profile_steps(cfg: Config, state, batch, step_fn, steps: int = 3, warm: int = 2):
    """``warm`` calls of ``step_fn``, then ``steps`` timed by CUDA events
    (before the profiler attaches: with it attached, and after, each launch
    costs more on the host), then ``steps`` more under the profiler.
    Returns (ms per step by CUDA events, kernel ms per step, kernel
    launches per step, host ms per step with the profiler on, [(kernel, ms
    per step, launches per step)] by device time)."""
    draws = make_draws(0, batch['text'].device)
    for _ in range(warm):
        step_fn(cfg, state, batch, draws)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        step_fn(cfg, state, batch, draws)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:     # kernels only
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn(cfg, state, batch, draws)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
               and not getattr(e, 'is_user_annotation', False)]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    top = [(e.key, _self_device_us(e) / 1e3 / steps, e.count / steps)
           for e in sorted(kernels, key=_self_device_us, reverse=True)]
    return step_ms, busy_ms, launches, wall_ms, top


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('--step', default='hoisted', choices=['hoisted', 'scanned'])
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--frames', type=int, default=400)
    p.add_argument('--text', type=int, default=64)
    p.add_argument('--remat', type=int, default=1, choices=[0, 1])
    p.add_argument('--top', type=int, default=15)
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Config()
    cfg = dataclasses.replace(base, acoustic=dataclasses.replace(
        base.acoustic, remat_decoder=bool(a.remat)))
    state = A.init_state(cfg, 0, 'cuda')
    if a.step == 'scanned':
        state.step = cfg.acoustic.tf_start_decay + 10000
    batch = seeded_batch(cfg, cfg.acoustic.batch_size, a.frames, a.text)
    fn = A.train_step_hoisted if a.step == 'hoisted' else A.train_step
    step_ms, busy_ms, launches, wall_ms, top = profile_steps(cfg, state, batch, fn, a.steps)
    print(f'{torch.cuda.get_device_name(0)}; {a.step} step, remat {a.remat}, '
          f'B={cfg.acoustic.batch_size}, {a.frames} frames, {a.text} text: '
          f'{step_ms:.2f} ms per step (CUDA events, profiler off; {wall_ms:.2f} on the host '
          f'clock with it on), kernels {busy_ms:.2f} ms per step, device busy '
          f'{100 * busy_ms / step_ms:.1f}%, {launches:.0f} kernel launches per step')
    for key, ms, n in top[:a.top]:
        print(f'  {ms:9.3f} ms/step {100 * ms / busy_ms:5.1f}% {n:7.0f}/step  {key[:110]}')


if __name__ == '__main__':
    main()
