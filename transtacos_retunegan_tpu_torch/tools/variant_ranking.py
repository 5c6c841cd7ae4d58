"""Cross-variant GAN ranking table from GAN training legs.

Port of ``transtacos_retunegan_tpu/tools/variant_ranking.py``.
The reference's headline model-selection evidence is a relative ranking of
generator variants by mstft at 30 epochs on DataBaker
(``retunegan/hparam.py:45-56``): the template-fusing Retune variants beat
their plain from-mel counterparts by ~30%.  This tool collates leg
directories in the convergence session's layout (``<base>/gan_<V>/`` with
``gan_loss.csv`` and, when evaluated, ``quality_eval.json``): the port's own
``convergence_session`` output, or the JAX package's committed
``docs/convergence_r5/gan_*`` (the default, read only), and writes a
ranking table with the reference anchors alongside to ``--out`` (default
under ``runs/torch_port/``).  It reads files only; ``--device`` (default
``cuda``) raises without a card, as every study tool's does.

The training log prints WEIGHTED mstft (w_loss_mstft = 8); the table
divides by 8 so numbers sit on the reference's unweighted scale.  Held-out
``quality_eval.json`` metrics (vs ground truth) are appended when present.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.variant_ranking \
      [--base docs/convergence_r5] [--out runs/torch_port/RANKING.md] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

REF_ANCHORS = {          # reference retunegan/hparam.py:45-56 (DataBaker)
    'MelGAN': 10.084,
    'MelGANRetune': 7.000,
    'HiFiGAN': 10.346,
    'HiFiGANRetune': 7.041,
    'HiFiGANSplit': 11.320,
}
W_MSTFT = 8.0
R4_CURVE = 'docs/convergence_r4/gan_loss.csv'


def leg_row(base: str, name: str, leg_dir: str) -> dict:
    d = os.path.join(base, leg_dir)
    row = {'variant': name}
    csv = os.path.join(d, 'gan_loss.csv')
    if os.path.exists(csv):
        lines = open(csv).read().strip().split('\n')[1:]
        last = lines[-1].split(',')
        row['steps'] = int(last[0])
        row['mstft_end'] = round(float(last[2]) / W_MSTFT, 3)
    qe = os.path.join(d, 'quality_eval.json')
    if os.path.exists(qe):
        q = json.load(open(qe)).get('vocoder_vs_gl', {})
        if q:
            row['heldout_mstft'] = round(q['gan']['mstft'], 3)
            row['heldout_mcd'] = round(q['gan']['mcd'], 2)
            row['pesq_proxy'] = round(q['gan']['pesq_proxy'], 3)
            row['beats_gl'] = q['gan_beats_gl']
    row['ref_anchor'] = REF_ANCHORS.get(name)
    return row


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--base', default='docs/convergence_r5')
    p.add_argument('--out', default='runs/torch_port/RANKING.md')
    p.add_argument('--legs', default='MelGAN,MelGANRetune,HiFiGAN,'
                                     'HiFiGANRetune')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> list:
    """Write the table; returns its rows, best first."""
    from ..serve.pipeline import resolve_device
    args = parser().parse_args(argv)
    resolve_device(args.device)
    rows = [leg_row(args.base, v, f'gan_{v}')
            for v in args.legs.split(',')]
    # the round-4 RefineGAN_small curve at the same budget is the anchor
    # for the default generator (same corpus recipe + settings)
    if os.path.exists(R4_CURVE):
        lines = [ln.split(',') for ln in
                 open(R4_CURVE).read().strip().split('\n')[1:]]
        at = [ln for ln in lines if int(ln[0]) <= 4740]
        if at:
            rows.append({'variant': 'RefineGAN_small (r4 curve)',
                         'steps': int(at[-1][0]),
                         'mstft_end': round(float(at[-1][2]) / W_MSTFT, 3),
                         'ref_anchor': None})

    rows_sorted = sorted([r for r in rows if 'mstft_end' in r],
                         key=lambda r: r['mstft_end'])
    md = [
        '# Cross-variant GAN ranking',
        '',
        f'Legs under `{args.base}`.  `mstft` is the unweighted train-crop',
        'value at the end of each run (the reference anchor\'s scale);',
        'held-out columns score the trained generator against ground truth',
        'on the test split.  Reference anchors are DataBaker numbers',
        '(`retunegan/hparam.py:45-56`) — a different corpus, so the claim',
        'under test is the RANKING SHAPE (template-fusing Retune variants',
        'beat their plain from-mel counterparts), not absolute values.',
        '',
        '| variant | mstft@end ↓ | ref anchor | held-out mstft | MCD |'
        ' pesq_proxy | beats GL |',
        '|---|---|---|---|---|---|---|',
    ]
    for r in rows_sorted:
        md.append(
            f"| {r['variant']} | **{r.get('mstft_end', '')}** |"
            f" {r.get('ref_anchor') or ''} |"
            f" {r.get('heldout_mstft', '')} | {r.get('heldout_mcd', '')} |"
            f" {r.get('pesq_proxy', '')} | {r.get('beats_gl', '')} |")
    ok = all(
        any(r['variant'] == a and s['variant'] == b
            and r['mstft_end'] < s['mstft_end']
            for r in rows_sorted for s in rows_sorted)
        for a, b in (('MelGANRetune', 'MelGAN'),
                     ('HiFiGANRetune', 'HiFiGAN')))
    md += ['', f'**Retune-beats-plain reproduced: {ok}** '
           '(the reference ranking\'s key finding).', '']
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as fh:
        fh.write('\n'.join(md))
    print('\n'.join(md))
    return rows_sorted


if __name__ == '__main__':
    main()
