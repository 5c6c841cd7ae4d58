"""A seeded synthetic corpus for the vocoder trainer.

Each utterance is a harmonic tone whose f0 glides through random
keypoints (90-300 Hz, with a slow vibrato), under a syllable-rate
amplitude envelope, with a few bursts of white noise over a white noise
floor 40 dB under the peak; written with
``audio.features.save_wav`` beside the index files that
``data.vocoder_data.VocoderDataset`` reads in scratch mode
(``train.txt``, ``test.txt``, ``wav_path.txt``).  Nothing is downloaded.

    python -m transtacos_retunegan_tpu_torch.tools.tone_corpus OUT_DIR \\
        [--train 68] [--test 4] [--min_s 1] [--max_s 4] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from ..audio.features import save_wav
from ..config import AudioConfig


def utterance(rng: np.random.RandomState, sample_rate: int, seconds: float) -> np.ndarray:
    """One float32 utterance of ``seconds``, peak 0.5."""
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    keys = rng.uniform(90.0, 300.0, size=max(2, int(seconds * 3)))
    f0 = np.interp(t, np.linspace(0.0, t[-1], len(keys)), keys)
    f0 = f0 * (1.0 + 0.02 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    y = sum(np.sin(k * phase) / k for k in range(1, 11))
    syllable_hz = rng.uniform(3.0, 5.0)
    y = y * (0.55 + 0.45 * np.sin(2 * np.pi * syllable_hz * t + rng.uniform(0, 2 * np.pi)))
    for _ in range(rng.randint(1, 4)):
        width = int(rng.uniform(0.03, 0.12) * sample_rate)
        start = rng.randint(0, max(1, n - width))
        y[start:start + width] += 0.8 * rng.randn(min(width, n - start))
    y = 0.5 * y / np.abs(y).max()
    # a recording's noise floor, 40 dB under the peak: no STFT bin is empty,
    # so the log-magnitudes the losses and the STFT discriminator take are
    # not logs of rounding noise
    return (y + 0.005 * rng.randn(n)).astype(np.float32)


def write_corpus(out_dir: str, cfg: AudioConfig, n_train: int, n_test: int,
                 seed: int = 0, min_s: float = 1.0, max_s: float = 4.0) -> List[int]:
    """Write ``n_train + n_test`` utterances of ``min_s``-``max_s`` seconds
    and the index files into ``out_dir``; returns their lengths in
    samples.  The wavs live in ``out_dir/wavs``."""
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, 'wavs')
    os.makedirs(wav_dir, exist_ok=True)
    names, lengths = [], []
    for i in range(n_train + n_test):
        y = utterance(rng, cfg.sample_rate, rng.uniform(min_s, max_s))
        names.append(f'tone{i:04d}')
        lengths.append(len(y))
        save_wav(y, os.path.join(wav_dir, f'{names[-1]}.wav'), cfg)
    for split, part in (('train', names[:n_train]), ('test', names[n_train:])):
        with open(os.path.join(out_dir, f'{split}.txt'), 'w', encoding='utf-8') as fh:
            fh.write(''.join(f'{n}|tone\n' for n in part))
    with open(os.path.join(out_dir, 'wav_path.txt'), 'w') as fh:
        fh.write(os.path.abspath(wav_dir))
    return lengths


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('out_dir')
    p.add_argument('--train', type=int, default=68)
    p.add_argument('--test', type=int, default=4)
    p.add_argument('--min_s', type=float, default=1.0)
    p.add_argument('--max_s', type=float, default=4.0)
    p.add_argument('--seed', type=int, default=0)
    a = p.parse_args(argv)
    write_corpus(a.out_dir, AudioConfig(), a.train, a.test, a.seed, a.min_s, a.max_s)


if __name__ == '__main__':
    main()
