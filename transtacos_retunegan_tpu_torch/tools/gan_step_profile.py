"""Where a GAN step's time goes on the card.

torch.profiler over a few ``gan_train_step`` calls at the default
``Config()`` (seeded weights, a seeded batch of B=16 segments), after a
warm-up: the kernels by device time and the kernel launches per step;
then the same steps without the profiler, timed by CUDA events, and the
device's busy share: the kernels' time over that step time.

    python -m transtacos_retunegan_tpu_torch.tools.gan_step_profile \\
        [--steps 5] [--compute_dtype float32|bfloat16] [--top 15]
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
from ..train import vocoder_step as vs


def _self_device_us(event) -> float:
    return float(getattr(event, 'self_device_time_total', None)
                 or getattr(event, 'self_cuda_time_total', 0) or 0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=5)
    p.add_argument('--compute_dtype', default='float32', choices=['float32', 'bfloat16'])
    p.add_argument('--top', type=int, default=15)
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Config()
    cfg = dataclasses.replace(base, vocoder=dataclasses.replace(
        base.vocoder, compute_dtype=a.compute_dtype))
    b, seg, hop = cfg.vocoder.batch_size, cfg.audio.segment_size, cfg.audio.hop_length
    r = np.random.RandomState(0)
    batch = {'mel': r.randn(b, seg // hop, cfg.audio.n_mel), 'tmpl': 0.1 * r.randn(b, seg),
             'wav': 0.1 * r.randn(b, seg)}
    batch = {k: torch.tensor(v, dtype=torch.float32, device='cuda') for k, v in batch.items()}
    state = vs.init_gan_state(cfg, 0, 'cuda')
    noise = torch.Generator(device='cuda').manual_seed(0)
    for _ in range(3):
        vs.gan_train_step(cfg, state, batch, noise, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.steps):
            vs.gan_train_step(cfg, state, batch, noise, 4)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the kernels themselves: not the operators that launched them, nor
    # the ranges annotated on the device's timeline (optimizer steps)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
               and not getattr(e, 'is_user_annotation', False)
               and not e.key.startswith('Optimizer.')]
    busy_ms = sum(_self_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(a.steps):
        vs.gan_train_step(cfg, state, batch, noise, 4)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / a.steps
    print(f'{torch.cuda.get_device_name(0)}; {a.compute_dtype}, B={b}, {a.steps} steps: '
          f'{step_ms:.2f} ms per step (CUDA events, profiler off; {wall_ms / a.steps:.2f} '
          f'on the host clock with it on), kernels {busy_ms / a.steps:.2f} ms per step, '
          f'device busy {100 * busy_ms / a.steps / step_ms:.1f}%, '
          f'{launches / a.steps:.0f} kernel launches per step')
    for e in sorted(kernels, key=_self_device_us, reverse=True)[:a.top]:
        us = _self_device_us(e)
        print(f'  {us / 1e3 / a.steps:9.3f} ms/step {100 * us / 1e3 / busy_ms:5.1f}% '
              f'{e.count // a.steps:5d}/step  {e.key[:110]}')


if __name__ == '__main__':
    main()
