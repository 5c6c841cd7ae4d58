"""Steady-state time of each synthesis and training stage on the card.

Port of ``transtacos_retunegan_tpu/tools/profile_stages.py``.  Each stage
runs once (its first call: cuDNN's and cuBLAS's algorithm choices, the
kernels' build), then ``--warmup`` calls, then ``--reps`` calls between
two CUDA events; one line per stage, at the default ``Config()``:

* the acoustic stage of one request (text padded to 80): the encoder, the
  per-step decode (``fused_decode``: 80 ``decode_step_kernel`` launches per
  call, bf16 weights) and the posnet, from the JAX server's initial weights
  (``PRNGKey(0)``);
* the vocoder's preparation: natural scale, mel and the Griffin-Lim
  template of 400 frames;
* the generator's forward (initial weights from ``PRNGKey(1)``);
* the GAN step (D x2 + G) at B=16 segments (``max(5, reps // 2)`` calls);
* the scanned acoustic step at B16 x T400 x N32.

Float32 matmuls and convolutions with TF32 off.  ``--device`` defaults to
``cuda`` (raises without a card).  ``main``
returns the stages' ms by name.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.profile_stages [--reps 24] \\
      [--warmup 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

STAGES = ('acoustic: encoder + fused decode + posnet',
          'vocoder: natural-scale -> mel + GL template',
          'vocoder: generator forward',
          'train: GAN step (D x2 + G, bs 16)',
          'train: acoustic step (bs 16 x 400 frames)')


def bench(name, f, reps: int, warmup: int, device) -> float:
    """ms per call of ``f`` after its first call and ``warmup`` more."""
    from .acoustic_step_ab import seconds
    first_s = seconds(f, device)
    for _ in range(warmup):
        f()

    def calls():
        for _ in range(reps):
            f()
    ms = seconds(calls, device) / reps * 1000
    print(f'{name:<44s} {ms:8.2f} ms   (first call {first_s:.1f}s)', flush=True)
    return ms


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--reps', type=int, default=24)
    p.add_argument('--warmup', type=int, default=8)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """One line per stage; returns the stages' ms by name."""
    from ..serve.pipeline import resolve_device
    from .acoustic_step_ab import true_float32
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    with true_float32():
        return stages(args, dev)


def stages(args, dev: torch.device) -> dict:
    from .. import jax_random
    from ..audio import dsp
    from ..config import Config
    from ..models.acoustic import Tacotron, posnet_apply
    from ..models.generators import make_generator
    from ..models.precision import compute_dtype
    from ..ops.fused_decoder import fold_params, fused_decode
    from ..text import frontend
    from ..text.symbols import get_vocab_size
    from ..train import acoustic_step as A
    from ..train import vocoder_step as V
    from ..train.train_acoustic import make_draws
    from ..weights import flax_acoustic_init, flax_vocoder_init
    from .convergence_session import device_line

    reps, warm = args.reps, args.warmup
    cfg = Config()
    au = cfg.audio
    max_iters, t_frames = 80, 400
    print(f'device: {device_line(dev)}')
    out = {}

    # ---- serving stages (batch 1)
    pinyin = ('zhe4 shi4 yi2 ge4 yong4 lai2 ce4 shi4 he2 cheng2 su4 du4 de5 '
              'chang2 ju4 zi5 ni3 hao3 shi4 jie4')
    seq = frontend.serialize_inference(pinyin)
    n_pad = 80
    text = np.zeros((1, n_pad, 2), np.int32)
    text[0, :seq.shape[0]] = seq
    tj = torch.from_numpy(text).to(dev)
    lj = torch.tensor([seq.shape[0]], device=dev)
    model = flax_acoustic_init(Tacotron(cfg), jax_random.prng_key(0)).to(dev).eval()
    fp = fold_params(model.decoder_cell)

    @torch.no_grad()
    def acoustic():
        enc = model(tj, lj)
        mel = fused_decode(fp, enc['keys'], enc['values'], enc['mask'], max_iters)
        return posnet_apply(model, mel['mel_outputs'])
    out[STAGES[0]] = bench(STAGES[0], acoustic, reps, warm, dev)

    gen = flax_vocoder_init(make_generator(cfg), jax_random.prng_key(1)).to(dev).eval()
    rng0 = np.random.RandomState(0)
    mag = torch.from_numpy(np.abs(rng0.randn(au.n_freq - 1, t_frames)).astype(np.float32)
                           * 0.01).to(dev)
    phase = torch.Generator(device=dev).manual_seed(3)

    def prep():
        s = dsp.fix_zero_dc(dsp.spec_to_natural_scale(mag, au), au)
        mel = torch.log(torch.clamp(dsp.mag_to_mel(s, au), min=dsp.EPS_AMP))
        log_mag = torch.log(torch.clamp(s, min=dsp.EPS_AMP))
        tmpl = dsp.inv_log_mag(log_mag, au, length=au.hop_length * t_frames - 1,
                               generator=phase)
        return mel, torch.nn.functional.pad(tmpl, (0, 1))
    mel, tmpl = prep()
    out[STAGES[1]] = bench(STAGES[1], prep, reps, warm, dev)

    @torch.no_grad()
    def gen_fwd():
        with compute_dtype(cfg.vocoder.compute_dtype, dev):
            return gen(mel.T[None], tmpl[None, :, None])
    out[STAGES[2]] = bench(STAGES[2], gen_fwd, reps, warm, dev)

    # ---- training steps (reference batch geometry)
    b, seg = cfg.vocoder.batch_size, au.segment_size
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    vb = {'mel': t(rng0.randn(b, seg // au.hop_length, au.n_mel)),
          'tmpl': t(rng0.randn(b, seg) * 0.1), 'wav': t(rng0.randn(b, seg) * 0.1)}
    gstate = V.init_gan_state(cfg, 0, dev)
    noise = torch.Generator(device=dev).manual_seed(0)
    out[STAGES[3]] = bench(STAGES[3], lambda: V.gan_train_step(cfg, gstate, vb, noise, 568),
                           max(5, reps // 2), warm, dev)

    n_txt, t_ = 32, 400
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    ab = {'text': i32(np.stack([rng0.randint(4, get_vocab_size(), (b, n_txt)),
                                rng0.randint(0, 6, (b, n_txt))], -1)),
          'text_lengths': i32(np.full((b,), n_txt)),
          'prds': i32(rng0.randint(0, 6, (b, n_txt))),
          'spec_lengths': i32(np.full((b,), t_)),
          'mel_targets': t(rng0.randn(b, t_, au.n_mel)),
          'mag_targets': t(rng0.randn(b, t_, au.n_freq - 1)),
          'f0_targets': i32(rng0.randint(0, au.n_f0_bins, (b, t_))),
          'c0_targets': i32(rng0.randint(0, 32, (b, t_))),
          'stop_token_targets': t(np.zeros((b, t_))),
          'frame_loss_len': i32(np.asarray(t_)), 'text_loss_len': i32(np.asarray(n_txt))}
    astate = A.init_state(cfg, 5, dev)
    draws = make_draws(0, dev)
    out[STAGES[4]] = bench(STAGES[4], lambda: A.train_step(cfg, astate, ab, draws),
                           max(5, reps // 2), warm, dev)
    return out


if __name__ == '__main__':
    main()
