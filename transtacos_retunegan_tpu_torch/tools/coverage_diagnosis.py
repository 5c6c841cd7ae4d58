"""Per-utterance, per-token diagnosis of argmax-coverage stragglers.

Port of ``transtacos_retunegan_tpu/tools/coverage_diagnosis.py``.
``alignment_diagonality``'s argmax ``coverage`` structurally under-counts
at r=5: a token attended for less than ~one decode step (62.5 ms) can
never win an argmax even under a perfect alignment.  This tool classifies
every token that never wins an argmax:

* ``structural``  -- attention mass < ``struct_thresh`` decode steps: the
  token is too short to own a step at r=5; argmax coverage CANNOT count
  it regardless of alignment quality (its mass is still on-diagonal).
* ``genuine_skip`` -- mass >= ``struct_thresh``: the model really did
  blur or skip a token that had room to win; these are the true quality
  signal.

Writes per-utterance rows (token symbol, mass in decode steps) plus a
summary with the coverage number RE-SCORED over only the tokens that could
structurally win (``coverage_winnable``).  The held-out texts decode on
``--device`` (default ``cuda``; raises without a card) through
``Synthesizer(acoustic_dir=)``, one ``decode_full`` launch each.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.coverage_diagnosis \
      --data_dir /tmp/r5/processed --acoustic_dir /tmp/r5/ac_run \
      --config /tmp/r5/cfg [--out runs/torch_port/coverage_diagnosis.json] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

import numpy as np


def diagnose_alignment(align: np.ndarray, symbols: list,
                       struct_thresh: float = 1.0) -> dict:
    """Classify non-argmax-winning tokens of one utterance.

    ``align`` is [n_text, n_decode_steps] trimmed to the true text length;
    ``symbols`` the same-length token strings.
    """
    a = np.asarray(align, np.float64)
    n_text, n_steps = a.shape
    winners = set(np.unique(np.argmax(a, axis=0)).tolist())
    mass = a.sum(axis=1)                       # decode steps per token
    missed = []
    for i in range(n_text):
        if i in winners:
            continue
        missed.append({
            'pos': i,
            'symbol': symbols[i] if i < len(symbols) else '?',
            'mass_steps': round(float(mass[i]), 3),
            'kind': ('structural' if mass[i] < struct_thresh
                     else 'genuine_skip'),
        })
    winnable = [i for i in range(n_text)
                if i in winners or mass[i] >= struct_thresh]
    covered_winnable = [i for i in winnable if i in winners]
    return {
        'n_text': n_text,
        'coverage': round(len(winners) / max(n_text, 1), 4),
        'coverage_winnable': round(
            len(covered_winnable) / max(len(winnable), 1), 4),
        'n_structural': sum(m['kind'] == 'structural' for m in missed),
        'n_genuine_skip': sum(m['kind'] == 'genuine_skip' for m in missed),
        'missed': missed,
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--acoustic_dir', required=True)
    p.add_argument('--config', default=None)
    p.add_argument('--out', default='runs/torch_port/coverage_diagnosis.json')
    p.add_argument('--max_texts', type=int, default=20)
    p.add_argument('--struct_thresh', type=float, default=1.0,
                   help='attention-mass threshold (decode steps) below '
                        'which a token cannot reliably win an argmax at '
                        'r=5 (one decode step = r*hop = 62.5 ms)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The diagnosis; returns what it writes to ``--out``."""
    from ..config import Config
    from ..serve.pipeline import Synthesizer, resolve_device
    from ..text import frontend
    from .convergence_session import held_out_texts

    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = Config.load(args.config) if args.config else Config()
    synth = Synthesizer(cfg, acoustic_dir=args.acoustic_dir, devices=[args.device])
    rows = []
    for name, text, _ in held_out_texts(args.data_dir)[:args.max_texts]:
        out = synth.synthesize_with_alignment(text)
        seq = frontend.serialize_inference(text, cfg.acoustic.g2p)
        symbols = frontend.deserialize(np.asarray(seq), cfg.acoustic.g2p)
        d = diagnose_alignment(out['alignment'], list(symbols),
                               args.struct_thresh)
        d['name'] = name
        d['text'] = text
        rows.append(d)
        print(f"# {name}: coverage {d['coverage']:.3f} -> winnable "
              f"{d['coverage_winnable']:.3f} (structural "
              f"{d['n_structural']}, genuine {d['n_genuine_skip']})",
              flush=True)

    sym_hist = Counter(m['symbol'] for r in rows for m in r['missed'])
    struct_hist = Counter(m['symbol'] for r in rows for m in r['missed']
                          if m['kind'] == 'structural')
    res = {
        'struct_thresh_steps': args.struct_thresh,
        'mean_coverage': round(float(np.mean([r['coverage']
                                              for r in rows])), 4),
        'mean_coverage_winnable': round(
            float(np.mean([r['coverage_winnable'] for r in rows])), 4),
        'total_missed': sum(len(r['missed']) for r in rows),
        'total_structural': sum(r['n_structural'] for r in rows),
        'total_genuine_skip': sum(r['n_genuine_skip'] for r in rows),
        'missed_symbol_hist': dict(sym_hist.most_common()),
        'structural_symbol_hist': dict(struct_hist.most_common()),
        'per_utt': rows,
    }
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(res, fh, indent=2)
    print(json.dumps({k: res[k] for k in
                      ('mean_coverage', 'mean_coverage_winnable',
                       'total_structural', 'total_genuine_skip')}))
    print(f'# wrote {args.out}')
    return res


if __name__ == '__main__':
    main()
