"""Vocoder batch-inference CLI, ported from
``transtacos_retunegan_tpu/serve/infer_vocoder.py`` (capability rebuild of
``retunegan/infer.py``).

Iterates a folder: ``.npy`` files are normalized magnitude features from
the acoustic preprocessor (``mag-*.npy``) and are vocoded; ``.wav`` files
go through an analysis -> resynthesis round trip.  Loads the run's frozen
``config.json`` and its newest ``g_*`` checkpoint (none: a warning and
the JAX tool's initial weights, from ``PRNGKey(0)``).  The Griffin-Lim template
comes from the host's ``audio.transforms.inv_log_mag`` (the native library
by default, ``--gl_engine numpy`` on request); the generator runs in
float32 (TF32 off) on ``--device``, which defaults to ``cuda`` and raises
without a card.

Usage:
  python -m transtacos_retunegan_tpu_torch.serve.infer_vocoder \\
      --run_dir runs/vocoder --input_dir specs/ --output_dir wavs/
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn as nn

from .. import jax_random
from ..audio import features, transforms as T
from ..config import Config
from ..models.generators import make_generator
from ..train import checkpoint as ckpt
from ..weights import flax_vocoder_init
from .pipeline import resolve_device


def load_generator(run_dir: str, cfg: Config, device='cuda') -> nn.Module:
    """The configured generator on ``device`` with the run's newest ``g_*``
    weights, or (with a warning) the JAX tool's initial ones, drawn from
    ``PRNGKey(0)``, when it has none."""
    gen = flax_vocoder_init(make_generator(cfg), jax_random.prng_key(0))
    gen = gen.to(resolve_device(device)).eval()
    if ckpt.restore_generator_params(run_dir, gen) is None:
        print(f'warning: no g_* checkpoint under {run_dir}; using random init')
    return gen


@torch.no_grad()
def _generate(gen: nn.Module, mel: np.ndarray, tmpl: np.ndarray) -> np.ndarray:
    """log mel [M, T] and template [hop * T] -> float32 wav on the host."""
    dev = next(gen.parameters()).device
    wav = gen(torch.from_numpy(np.ascontiguousarray(mel.T))[None].to(dev),
              torch.from_numpy(tmpl)[None, :, None].to(dev))
    return wav[0, :, 0].float().cpu().numpy()


def vocode_mag_norm(gen: nn.Module, mag_norm: np.ndarray, cfg: Config,
                    engine: str = 'native') -> np.ndarray:
    """Normalized mag [F, T] (preprocessor domain) -> waveform."""
    mag_nat = T.spec_to_natural_scale(mag_norm, cfg.audio)
    mag_nat = T.fix_zero_dc(mag_nat, cfg.audio)
    log_mag = np.log(np.maximum(mag_nat, 1e-5)).astype(np.float32)
    mel = np.log(np.maximum(T.mag_to_mel(mag_nat.astype(np.float32), cfg.audio),
                            1e-5)).astype(np.float32)
    wavlen = cfg.audio.hop_length * mag_norm.shape[1]
    tmpl = T.inv_log_mag(log_mag, cfg.audio, length=wavlen - 1, engine=engine)
    return _generate(gen, mel, np.pad(tmpl, (0, 1)))


def roundtrip_wav(gen: nn.Module, wav: np.ndarray, cfg: Config,
                  engine: str = 'native') -> np.ndarray:
    """wav -> analysis -> vocoder -> wav (quality sanity path)."""
    wav = features.align_wav(wav, cfg.audio.hop_length)
    log_mag = T.get_mag(wav[:-1], cfg.audio)
    mel = np.log(np.maximum(T.mag_to_mel(np.exp(log_mag), cfg.audio), 1e-5))
    tmpl = T.inv_log_mag(log_mag, cfg.audio, length=len(wav) - 1, engine=engine)
    return _generate(gen, mel.astype(np.float32), np.pad(tmpl, (0, 1)))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--run_dir', required=True)
    p.add_argument('--input_dir', required=True)
    p.add_argument('--output_dir', required=True)
    p.add_argument('--gl_engine', default='native', choices=T.ENGINES,
                   help='the Griffin-Lim template: the native library (default) or numpy')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg_path = os.path.join(args.run_dir, 'config.json')
    cfg = Config.load(cfg_path) if os.path.exists(cfg_path) else Config()
    os.makedirs(args.output_dir, exist_ok=True)
    gen = load_generator(args.run_dir, cfg, device)

    for fn in sorted(os.listdir(args.input_dir)):
        fp = os.path.join(args.input_dir, fn)
        base = os.path.splitext(fn)[0]
        out_fp = os.path.join(args.output_dir, base + '.gen.wav')
        start = time.time()
        if fn.endswith('.npy'):
            wav = vocode_mag_norm(gen, np.load(fp), cfg, args.gl_engine)
        elif fn.endswith('.wav'):
            wav = roundtrip_wav(gen, features.load_wav(fp, cfg.audio), cfg, args.gl_engine)
        else:
            continue
        features.save_wav(wav, out_fp, cfg.audio)
        print(f'{fn} -> {out_fp} ({time.time() - start:.2f}s, {len(wav)} samples)')


if __name__ == '__main__':
    main()
