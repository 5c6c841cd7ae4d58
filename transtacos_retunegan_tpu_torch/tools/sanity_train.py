"""End-to-end learning sanity: synthesize a tiny tonal corpus, train the
acoustic model a few hundred steps through the port's CLI, and verify the
loss drops and a trained checkpoint synthesizes audio in the corpus's
spectral neighborhood.  A second leg trains the vocoder GAN through its CLI
and verifies the mstft reconstruction loss drops while the discriminator
real/fake scores separate (LSGAN: real -> 1, fake -> 0).

Port of ``transtacos_retunegan_tpu/tools/sanity_train.py`` with the same
corpus, reduced widths and thresholds: loss drop > 0.3 over ``--steps``,
mstft drop > 0.15 and discriminator separation > 0.15 over the GAN leg
(half of ``--gan_steps``, as in the JAX tool: ``gan_leg``), and the
synthesized wav's dominant frequency between 100 and 600 Hz.  Both
trainers run as ``transtacos_retunegan_tpu_torch.train.*`` subprocesses on
``--device``
(default ``cuda``; raises without a card), and the synthesis decodes on it
through ``Synthesizer(acoustic_dir=)``, one ``decode_full`` launch.

Usage: python -m transtacos_retunegan_tpu_torch.tools.sanity_train \
    [--steps 300] [--gan_steps 150] [--skip_acoustic] [--skip_gan] \
    [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import tempfile
from typing import Dict

import numpy as np

from ..audio import features as F
from ..config import Config
from ..data import preprocess as P
from .convergence_session import ACOUSTIC_CLI, VOCODER_CLI, run_cli

PINYINS = ['ni3 hao3 shi4 jie4', 'zhong1 guo2 ren2', 'wo3 men5 de5 jia1',
           'tian1 qi4 zhen1 hao3', 'xie4 xie4 da4 jia1', 'zai4 jian4 peng2 you3',
           'chi1 fan4 le5 ma5', 'jin1 tian1 xing1 qi1 ji3']
LOSS_DROP, MSTFT_DROP, SEPARATION, PEAK_HZ = 0.3, 0.15, 0.15, (100.0, 600.0)
SYNTH_TEXT = 'ni3 hao3 shi4 jie4'


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def build_corpus(base: str, cfg: Config) -> str:
    os.makedirs(f'{base}/wavs', exist_ok=True)
    rows = []
    for i, py in enumerate(PINYINS):
        dur = 11025 + (i % 4) * 2200
        t = np.arange(dur) / cfg.audio.sample_rate
        f0 = 160 + 25 * (i % 3)
        env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
        y = (env * (0.4 * np.sin(2 * np.pi * f0 * t)
                    + 0.15 * np.sin(2 * np.pi * 2 * f0 * t))).astype(np.float32)
        F.save_wav(y, f'{base}/wavs/u{i}.wav', cfg.audio)
        rows.append(f'u{i}|{py}|{"0" * (len(py.split()) - 1)}4')
    with open(f'{base}/metadata.csv', 'w', encoding='utf-8') as fh:
        fh.write('\n'.join(rows))
    P.preprocess_generic(base, 'processed', f'{base}/metadata.csv',
                         wav_dir='wavs', num_workers=1)
    return f'{base}/processed'


def tiny_config(cfg: Config) -> Config:
    return dataclasses.replace(cfg, acoustic=dataclasses.replace(
        cfg.acoustic, embed_depth=64, encoder_depth=64, decoder_depth=128,
        attention_depth=32, prenet_depths=(64,), posnet_depth=128,
        var_embed_depth=32, var_prednet_depth=32, prdsnet_depth=32,
        posenc_depth=16, batch_size=4, frame_bucket=40))


def tiny_vocoder_config(cfg: Config) -> Config:
    """Reduced widths; keeps the reference's GAN dynamics (d_train_times=2,
    all three discriminator families, loss weights)."""
    return dataclasses.replace(cfg, vocoder=dataclasses.replace(
        cfg.vocoder, upsample_initial_channel=64, batch_size=4,
        num_workers=1, disc_width_mult=0.5,
        multi_stft_params=((1024, 512, 120), (512, 256, 60))))


def gan_leg(base: str, data_dir: str, gan_steps: int, device: str = 'cuda') -> Dict[str, float]:
    """Vocoder GAN sanity: mstft drops, D real/fake scores separate.
    Returns the early and late means, the two checked values and the last
    step logged.  As in the JAX tool, ``gan_steps // 2`` epochs of what it
    takes to be two steps each: the 8-utterance corpus keeps 7 for
    training and the loader drops a short last batch, so an epoch is one
    step and the leg trains half of ``gan_steps``."""
    cfg_path = tiny_vocoder_config(Config()).save(f'{base}/vcfg')
    steps_per_epoch = 2                      # 8 utts / batch 4
    epochs = max(1, gan_steps // steps_per_epoch)
    out = run_cli(VOCODER_CLI,
                  ['--data_dir', data_dir, '--log_path', f'{base}/vrun',
                   '--config', cfg_path, '--finetune', '--epochs', str(epochs),
                   '--stdout_interval', '2', '--checkpoint_interval', str(gan_steps),
                   '--validation_interval', str(gan_steps), '--summary_interval',
                   str(gan_steps), '--device', device], timeout=7200)

    res = gan_stats(out)
    print(f'gan mstft {res["mstft_early"]:.3f} -> {res["mstft_late"]:.3f} '
          f'({res["mstft_drop"]:.0%} drop)')
    print(f'D score separation (real-fake) {res["separation_early"]:.3f} -> '
          f'{res["separation"]:.3f}')
    _check(res['mstft_drop'] > MSTFT_DROP,
           f'mstft dropped only {res["mstft_drop"]:.0%} over {gan_steps} steps')
    _check(res['separation'] > SEPARATION,
           f'D real/fake scores did not separate ({res["separation"]:.3f})')
    print('SANITY GAN: OK')
    return res


def gan_stats(out: str) -> Dict[str, float]:
    """The GAN leg's numbers from the vocoder trainer's stdout: the mean
    mstft of the first and of the last fifth of the logged steps and the
    drop between them, the discriminator's real-minus-fake score over the
    same windows, and the last step logged."""
    logged = [int(x) for x in re.findall(r'\[(\d+) \(', out)]
    mstft = [float(x) for x in re.findall(r'mstft: (\d+\.\d+)', out)]
    sc_r = [float(x) for x in re.findall(r'sc_s_r: (-?\d+\.\d+)', out)]
    sc_g = [float(x) for x in re.findall(r'sc_s_g: (-?\d+\.\d+)', out)]
    _check(len(mstft) >= 10, f'only {len(mstft)} mstft lines in trainer output')
    k = max(2, len(mstft) // 5)
    early, late = float(np.mean(mstft[:k])), float(np.mean(mstft[-k:]))
    return {'mstft_early': early, 'mstft_late': late, 'mstft_drop': 1 - late / early,
            'separation_early': float(np.mean(np.asarray(sc_r[:k]) - np.asarray(sc_g[:k]))),
            'separation': float(np.mean(np.asarray(sc_r[-k:]) - np.asarray(sc_g[-k:]))),
            'gan_steps_run': logged[-1]}


def acoustic_leg(base: str, data_dir: str, cfg_path: str, steps: int,
                 device: str = 'cuda') -> Dict[str, float]:
    """Train the tiny acoustic model ``steps`` steps; the loss must drop."""
    out = run_cli(ACOUSTIC_CLI,
                  ['--data_dir', data_dir, '--log_path', f'{base}/run',
                   '--config', cfg_path, '--max_steps', str(steps),
                   '--log_interval', '25', '--checkpoint_interval', str(steps),
                   '--device', device], timeout=7200)
    losses = [float(x) for x in re.findall(r'loss (\d+\.\d+)', out)]
    _check(bool(losses), 'no loss lines in trainer output')
    drop = 1 - losses[-1] / losses[0]
    print(f'loss {losses[0]:.3f} -> {losses[-1]:.3f} ({drop:.0%} drop)')
    _check(drop > LOSS_DROP, f'loss dropped only {drop:.0%} over {steps} steps')
    return {'loss_first': losses[0], 'loss_last': losses[-1], 'loss_drop': drop}


def synthesis_check(run: str, device: str = 'cuda') -> Dict[str, float]:
    """Synthesize from the trained checkpoint (40 decode steps at most, the
    acoustic service's Griffin-Lim); its dominant frequency must lie in
    the corpus's band."""
    from ..serve.pipeline import Synthesizer
    cfg = Config.load(f'{run}/config.json')
    synth = Synthesizer(cfg, acoustic_dir=run, max_iters=40, devices=[device])
    wav = synth.synthesize_wav(SYNTH_TEXT, trim=False)
    _check(len(wav) > 0 and bool(np.isfinite(wav).all()), 'synthesized wav empty or not finite')
    mag = np.abs(np.fft.rfft(wav * np.hanning(len(wav))))
    freqs = np.fft.rfftfreq(len(wav), 1 / cfg.audio.sample_rate)
    band = (freqs > 80) & (freqs < 1000)
    peak = float(freqs[band][np.argmax(mag[band])])
    print(f'synthesized {len(wav)} samples; dominant frequency {peak:.0f} Hz '
          f'(corpus fundamentals 160-210 Hz + harmonics)')
    _check(PEAK_HZ[0] < peak < PEAK_HZ[1], f'dominant frequency {peak} outside corpus band')
    return {'samples': len(wav), 'peak_hz': peak}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--gan_steps', type=int, default=150)
    p.add_argument('--skip_acoustic', action='store_true', default=False)
    p.add_argument('--skip_gan', action='store_true', default=False)
    p.add_argument('--workdir', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> Dict[str, float]:
    """Every leg asked for; the numbers behind each check."""
    from ..serve.pipeline import resolve_device
    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = Config()
    base = args.workdir or tempfile.mkdtemp(prefix='sanity_train_')
    data_dir = build_corpus(base, cfg)
    cfg_path = tiny_config(cfg).save(f'{base}/cfg')

    res: Dict[str, float] = {}
    if not args.skip_gan:
        res.update(gan_leg(base, data_dir, args.gan_steps, args.device))
    if args.skip_acoustic:
        return res
    res.update(acoustic_leg(base, data_dir, cfg_path, args.steps, args.device))
    res.update(synthesis_check(f'{base}/run', args.device))
    print('SANITY TRAIN: OK')
    return res


if __name__ == '__main__':
    main()
