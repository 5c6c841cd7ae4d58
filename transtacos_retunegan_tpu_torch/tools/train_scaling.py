"""Batch-size scaling of both train steps on one card (throughput study).

Port of ``transtacos_retunegan_tpu/tools/train_scaling.py``.  For each
batch size in ``--batches``: ms per step, samples per second and the
model-FLOP utilisation of

  * the acoustic hoisted-force train step (the step before the
    teacher-forcing decay, B x T400 x N32, ``acoustic_step_ab.make_batch``),
  * the vocoder GAN step (D x2 + G at segment 8192),

and with ``--stages`` the GAN step split into standalone stages (g_fwd,
mstft, d_fwd, d_fwdbwd, g_fwdbwd).  Each is timed by CUDA events as the
fastest of ``--trials`` trials of ``--steps`` calls after warm-up calls.

FLOPs: the JAX tool reads XLA's cost analysis; here
``torch.utils.flop_counter.FlopCounterMode`` counts one call (forward and
backward), and it counts only matrix products and convolutions (the JSON
says so).  ``mfu_pct`` divides by the card's peak for the step's type
(``PEAK_FLOPS``, keyed by the device's name: float32 with TF32 off, as
the trainers run, or bf16 for ``--compute_dtype bfloat16``); a card not in
the table gives ``null``.  ``--device`` defaults to ``cuda`` (raises
without a card).  Writes ``--out`` (default under ``runs/torch_port/``)
with the card's name and power limit.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.train_scaling \\
      [--batches 16,32,64] [--out runs/torch_port/train_scaling.json] [--tiny] \\
      [--compute_dtype float32|bfloat16] [--gan_only] [--stages] \\
      [--warm 6] [--steps 10] [--trials 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from .acoustic_step_ab import (make_batch, min_of_trials, tiny, time_step, true_float32,
                               write_json)

# Dense peak rates by card (the name torch.cuda.get_device_name gives):
# H100 SXM, bf16 tensor cores; float32 without TF32 (the CUDA cores).
PEAK_FLOPS = {'NVIDIA H100 80GB HBM3': {'bfloat16': 989.4e12, 'float32': 66.9e12}}
FLOPS_COUNTED = ('matrix products and convolutions only (torch.utils.flop_counter.'
                 'FlopCounterMode over one call, forward and backward)')
STEPS_PER_EPOCH = 568                      # the reference's anchor for the lr schedule


def peak_flops(device: torch.device, dtype: str) -> Optional[float]:
    """The card's dense peak for ``dtype``; None for a card (or the CPU)
    not in ``PEAK_FLOPS``."""
    if device.type != 'cuda':
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device), {}).get(dtype)


def counted_flops(call: Callable[[], object]) -> int:
    """The matrix-product and convolution FLOPs of one ``call()``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        call()
    return counter.get_total_flops()


def mfu(flops: int, seconds: float, peak: Optional[float]) -> Optional[float]:
    return round(100.0 * flops / seconds / peak, 2) if flops and peak else None


def gan_batch(cfg: Config, b: int, device):
    rng = np.random.RandomState(0)
    seg = cfg.audio.segment_size
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return {'mel': t(rng.randn(b, seg // 256, 80)), 'tmpl': t(rng.randn(b, seg) * 0.1),
            'wav': t(rng.randn(b, seg) * 0.1)}


def bench_acoustic(cfg: Config, b: int, t: int, n_txt: int, device, reps: dict) -> dict:
    from ..train import acoustic_step as A
    assert A.hoist_force_eligible(cfg, 0)
    batch = make_batch(cfg, b=b, n_txt=n_txt, t=t, device=device)
    step_s, state = time_step(cfg, batch, step_fn=A.train_step_hoisted, device=device, **reps)
    flops = counted_flops(lambda: A.train_step_hoisted(cfg, state, batch))
    return {'step_ms': round(step_s * 1000.0, 2),
            'samples_per_s': round(b / step_s, 1),
            'frames_per_s': round(b * t / step_s, 0),
            'mfu_pct': mfu(flops, step_s, peak_flops(device, 'float32')),
            'flops_per_step': flops}


def bench_gan(cfg: Config, b: int, device, reps: dict) -> dict:
    from ..train import vocoder_step as V
    vb = gan_batch(cfg, b, device)
    state = V.init_gan_state(cfg, 0, device)
    noise = torch.Generator(device=device).manual_seed(0)

    def run():
        return V.gan_train_step(cfg, state, vb, noise, STEPS_PER_EPOCH)
    best = min_of_trials(run, device, **reps)
    flops = counted_flops(run)
    seg = cfg.audio.segment_size
    return {'step_ms': round(best * 1000.0, 2),
            'samples_per_s': round(b / best, 1),
            'audio_s_per_s': round(b * seg / cfg.audio.sample_rate / best, 1),
            'mfu_pct': mfu(flops, best, peak_flops(device, cfg.vocoder.compute_dtype)),
            'flops_per_step': flops}


def gan_stages(cfg: Config, b: int, device, reps: dict) -> dict:
    """The GAN step's stages at batch ``b``, each timed alone."""
    from ..models import vocoder_losses as L
    from ..train import vocoder_step as V
    vb = gan_batch(cfg, b, device)
    state = V.init_gan_state(cfg, 0, device)
    gen, disc = state.generator, state.discriminators
    y = vb['wav']

    def g_out():
        return V.apply_generator(cfg, gen, vb, torch.Generator(device=device).manual_seed(7))
    with torch.no_grad():
        y_g = g_out()
        _, specs_r, specs_g = L.multi_stft_specs_and_loss(y, y_g, cfg)

    def d_loss():
        (sr, sg, _, _), (pr, pg, _, _), (tr, tg, _, _) = V._disc_forward(
            cfg, disc, y, y_g, specs_r, specs_g)
        return (L.discriminator_loss(sr, sg, cfg) + L.discriminator_loss(pr, pg, cfg)
                + L.discriminator_loss(tr, tg, cfg))

    def g_loss():
        y_hat = g_out()
        loss_mstft, sp_r, sp_g = L.multi_stft_specs_and_loss(y, y_hat, cfg)
        (sr, sg, fsr, fsg), (pr, pg, fpr, fpg), (tr, tg, ftr, ftg) = V._disc_forward(
            cfg, disc, y, y_hat, sp_r, sp_g)
        return (L.generator_loss(sg, sr, cfg) + L.generator_loss(pg, pr, cfg)
                + L.generator_loss(tg, tr, cfg)
                + (L.feature_loss(fsr, fsg) + L.feature_loss(fpr, fpg)
                   + L.feature_loss(ftr, ftg)) * cfg.vocoder.w_loss_fm
                + loss_mstft * cfg.vocoder.w_loss_mstft)

    fns = {'g_fwd': torch.no_grad()(g_out),
           'mstft': torch.no_grad()(lambda: L.multi_stft_specs_and_loss(y, y_g, cfg)[0]),
           'd_fwd': torch.no_grad()(lambda: V._disc_forward(cfg, disc, y, y_g, specs_r,
                                                            specs_g)),
           'd_fwdbwd': lambda: torch.autograd.grad(d_loss(), list(disc.parameters())),
           'g_fwdbwd': lambda: torch.autograd.grad(g_loss(), list(gen.parameters()))}
    peak = peak_flops(device, cfg.vocoder.compute_dtype)
    out = {}
    for name, fn in fns.items():
        s = min_of_trials(fn, device, **reps)
        out[name] = {'ms': round(s * 1000.0, 2), 'ms_per_sample': round(s * 1000.0 / b, 3),
                     'mfu_pct': mfu(counted_flops(fn), s, peak)}
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--batches', default='16,32,64')
    p.add_argument('--out', default='runs/torch_port/train_scaling.json')
    p.add_argument('--tiny', action='store_true', default=False,
                   help='tiny dims/geometry (CPU smoke of this script)')
    p.add_argument('--compute_dtype', default='float32', choices=['float32', 'bfloat16'],
                   help="the vocoder's precision in the GAN legs (bf16 autocast)")
    p.add_argument('--gan_only', action='store_true', default=False)
    p.add_argument('--stages', action='store_true', default=False,
                   help='also split the GAN step per batch size (g_fwd / mstft / '
                        'd_fwd / d_fwdbwd / g_fwdbwd, each timed alone)')
    p.add_argument('--warm', type=int, default=6, help='warm-up calls after the first')
    p.add_argument('--steps', type=int, default=10, help='calls per trial')
    p.add_argument('--trials', type=int, default=3, help='trials; the fastest is kept')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The study; returns what it writes to ``--out``."""
    from ..serve.pipeline import resolve_device
    from .convergence_session import device_line
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    batches = [int(x) for x in args.batches.split(',')]
    reps = dict(n_warm=args.warm, n=args.steps, n_trial=args.trials)
    cfg = Config()
    if args.compute_dtype != 'float32':
        cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(
            cfg.vocoder, compute_dtype=args.compute_dtype))
    t, n_txt = 400, 32
    if args.tiny:
        cfg = dataclasses.replace(tiny(cfg), vocoder=dataclasses.replace(
            cfg.vocoder, upsample_initial_channel=32, multi_stft_params=((512, 256, 60),)))
        t, n_txt, batches = 20, 12, batches[:2]

    result = {'device': device_line(device),
              'acoustic_geometry': f'T{t} x N{n_txt} (hoisted-force step)',
              'gan_geometry': f'segment {cfg.audio.segment_size}, '
                              'D x2 + G reference recipe',
              'gan_compute_dtype': cfg.vocoder.compute_dtype,
              'flops_counted': FLOPS_COUNTED,
              'acoustic': {}, 'gan': {}}
    with true_float32():
        if not args.gan_only:
            for b in batches:
                result['acoustic'][str(b)] = r = bench_acoustic(cfg, b, t, n_txt, device, reps)
                print(f'# acoustic bs{b}: {r}', flush=True)
        for b in batches:
            result['gan'][str(b)] = r = bench_gan(cfg, b, device, reps)
            print(f'# gan bs{b}: {r}', flush=True)
        if args.stages:
            result['gan_stages'] = {}
            for b in batches:
                result['gan_stages'][str(b)] = r = gan_stages(cfg, b, device, reps)
                print(f'# gan stages bs{b}: {r}', flush=True)

    base_g = result['gan'][str(batches[0])]['samples_per_s']
    result['derived'] = {'gan_speedup_vs_bs16_per_sample': {
        str(b): round(result['gan'][str(b)]['samples_per_s'] / base_g, 2) for b in batches}}
    if not args.gan_only:
        base_a = result['acoustic'][str(batches[0])]['samples_per_s']
        result['derived']['acoustic_speedup_vs_bs16_per_sample'] = {
            str(b): round(result['acoustic'][str(b)]['samples_per_s'] / base_a, 2)
            for b in batches}
    write_json(args.out, result)
    return result


if __name__ == '__main__':
    main()
