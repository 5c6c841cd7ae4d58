"""float32-vs-bfloat16 serving quality A/B on a TRAINED vocoder.

Port of ``transtacos_retunegan_tpu/tools/bf16_ab.py``.  Held-out items are
vocoded through the serving surface (``Synthesizer.vocode``) twice --
identical trained weights, identical input spec, ``infer_dtype`` float32
vs bfloat16 (autocast on ``--device``, default ``cuda``; raises without a
card) -- and both outputs are scored against the ground-truth waveform
(mstft / MCD / pesq_proxy / SNR), plus the direct float32-vs-bfloat16
output deviation.  Writes ``--out`` (default under ``runs/torch_port/``)
with the card's name and power limit.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.bf16_ab \
      --data_dir <processed> --vocoder_dir <vo_run> \
      [--out runs/torch_port/serving_bf16_ab.json] [--max_items 12] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--vocoder_dir', required=True)
    p.add_argument('--config', default=None)
    p.add_argument('--out', default='runs/torch_port/serving_bf16_ab.json')
    p.add_argument('--max_items', type=int, default=12)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The A/B; returns what it writes to ``--out``."""
    from ..audio import features as F
    from ..config import Config
    from ..eval.metrics import evaluate_pair
    from ..serve.pipeline import Synthesizer, resolve_device
    from .convergence_session import device_line

    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = Config.load(args.config) if args.config else Config()
    with open(os.path.join(args.data_dir, 'wav_path.txt')) as fh:
        wav_path = fh.read().strip()
    names = []
    with open(os.path.join(args.data_dir, 'test.txt'), encoding='utf-8') as fh:
        for line in fh:
            names.append(line.strip().split('|')[0])
    names = names[:args.max_items]

    synths = {dt: Synthesizer(cfg, vocoder_dir=args.vocoder_dir, infer_dtype=dt,
                              devices=[args.device])
              for dt in ('float32', 'bfloat16')}

    agg = {dt: {} for dt in synths}
    dev = []
    for name in names:
        # Input scale: both packages' ``vocode`` take a natural-scale
        # magnitude, and ``mag-*.npy`` holds the preprocessor's normalized
        # dB spectrum.  The JAX tool passes the file unconverted, and so
        # does this port, so that its numbers are the JAX tool's (the
        # vocoder's training data and ``infer_vocoder`` denormalize it
        # first; ROADMAP.md lists the difference as a both-packages item).
        mag = np.load(os.path.join(args.data_dir, f'mag-{name}.npy'))
        gt = F.load_wav(os.path.join(wav_path, f'{name}.wav'), cfg.audio)
        outs = {}
        for dt, synth in synths.items():
            wav = np.asarray(synth.vocode(mag), np.float32)
            outs[dt] = wav
            for k, v in evaluate_pair(gt, wav, cfg).items():
                agg[dt].setdefault(k, []).append(v)
        n = min(len(outs['float32']), len(outs['bfloat16']))
        dev.append(float(np.max(np.abs(outs['float32'][:n]
                                       - outs['bfloat16'][:n]))))

    res = {
        'n_items': len(names),
        'vocoder_dir': args.vocoder_dir,
        'per_dtype': {dt: {k: round(float(np.mean(v)), 4)
                           for k, v in d.items()} for dt, d in agg.items()},
        'max_abs_waveform_deviation': round(float(np.max(dev)), 5),
        'deltas_bf16_minus_f32': {
            k: round(float(np.mean(agg['bfloat16'][k])
                           - np.mean(agg['float32'][k])), 5)
            for k in agg['float32']},
        'device': device_line(args.device),
    }
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(res, fh, indent=2)
    print(json.dumps(res, indent=2))
    return res


if __name__ == '__main__':
    main()
