"""Spread of ``sanity_train``'s GAN checks over initial draws and runs.

``sanity_train``'s GAN leg compares the mean logged mstft of the first
fifth of its steps with that of the last fifth.  This tool runs that leg
as ``sanity_train`` does (its corpus, its tiny widths, ``gan_steps // 2``
epochs of one step each), once for each ``--seeds`` entry (the config's
``randseed``, which seeds the trainer's initial weights and noise; the
Griffin-Lim templates are computed once and cached with the corpus) and
``--repeats`` times each, optionally under deterministic algorithms, and
prints for each run the mstft drop and the separation against
``sanity_train``'s thresholds, and the trained generator's mean |y| on
the first training batch (1.0 is a tanh output saturated at ±1).  The
trainer runs in this process on ``--device`` (default ``cuda``; raises
without a card); its log is read from the run's ``rtg.log``.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.sanity_spread \
      [--seeds 114514,1,2] [--repeats 1] [--deterministic] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from ..config import Config
from ..data.vocoder_data import VocoderDataset, VocoderLoader
from ..serve.pipeline import resolve_device
from ..train import checkpoint as ckpt
from ..train import train_vocoder
from ..train.vocoder_step import apply_generator, init_gan_state
from ..utils.determinism import deterministic
from . import sanity_train as st


def gan_run(base: str, data_dir: str, seed: int, gan_steps: int, device: str,
            exact: bool) -> dict:
    """One GAN leg at ``randseed`` ``seed``: ``sanity_train.gan_stats`` of
    its log, whether both GAN checks held, and the mean |y| of the trained
    generator on the first training batch."""
    cfg = st.tiny_vocoder_config(Config())
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, randseed=seed))
    loader = VocoderLoader(VocoderDataset('train', data_dir, cfg, finetune=True),
                           cfg.vocoder.batch_size, num_workers=1)
    epochs = max(1, gan_steps // 2)
    steps = epochs * len(loader)
    argv = ['--data_dir', data_dir, '--log_path', f'{base}/vrun',
            '--config', cfg.save(f'{base}/vcfg'), '--finetune', '--epochs', str(epochs),
            '--stdout_interval', '2', '--checkpoint_interval', str(steps),
            '--validation_interval', str(gan_steps), '--summary_interval', str(gan_steps),
            '--device', device]
    if exact:
        with deterministic():
            train_vocoder.main(argv)
    else:
        train_vocoder.main(argv)
    with open(f'{base}/vrun/rtg.log') as f:
        res = st.gan_stats(f.read())
    generator = init_gan_state(cfg, 0, device).generator.eval()
    ckpt.restore_generator_params(f'{base}/vrun', generator)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(iter(loader)).items()}
    with torch.no_grad():
        res['mean_abs_y'] = float(apply_generator(cfg, generator, batch).abs().mean())
    res['held'] = bool(res['mstft_drop'] > st.MSTFT_DROP and res['separation'] > st.SEPARATION)
    return res


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--seeds', default=str(Config().audio.randseed))
    p.add_argument('--repeats', type=int, default=1)
    p.add_argument('--gan_steps', type=int, default=150)
    p.add_argument('--deterministic', action='store_true', default=False,
                   help="cuDNN's deterministic algorithms and PyTorch's deterministic "
                        'implementations (utils/determinism.py)')
    p.add_argument('--workdir', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> list:
    """One row per run: seed, repeat and ``gan_run``'s numbers."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    base = args.workdir or tempfile.mkdtemp(prefix='sanity_spread_')
    data_dir = st.build_corpus(f'{base}/corpus', Config())
    rows = []
    for seed in [int(s) for s in args.seeds.split(',')]:
        for r in range(args.repeats):
            res = gan_run(os.path.join(base, f'seed{seed}_{r}'), data_dir, seed,
                          args.gan_steps, args.device, args.deterministic)
            rows.append({'seed': seed, 'repeat': r, **{k: round(v, 4) if isinstance(v, float)
                                                       else v for k, v in res.items()}})
            print(json.dumps(rows[-1]), flush=True)
    held = sum(r['held'] for r in rows)
    print(f'# GAN checks held in {held} of {len(rows)} runs (mstft drop > '
          f'{st.MSTFT_DROP}, separation > {st.SEPARATION})', flush=True)
    return rows


if __name__ == '__main__':
    main()
