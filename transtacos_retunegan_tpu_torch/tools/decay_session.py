"""Train THROUGH the teacher-forcing decay, evaluating as it anneals.

Port of ``transtacos_retunegan_tpu/tools/decay_session.py``.  The
reference's 'mix' teacher-forcing mode blends ground truth with the model's
own predictions inside the decode loop under a cosine decay that engages at
``tf_start_decay`` (reference ``custom_decoder.py:106-151``,
``transtacos/hparam.py:73-81``).  This session drives a compressed-schedule
run and evaluates the SAME run repeatedly as tf_ratio anneals 1.0 -> 0.0:

1. build/reuse the evidence corpus (speaker bank, 4-16 syllables);
2. train the port's ``train_acoustic`` (a subprocess on ``--device``) in
   segments whose boundaries are the eval points, each resuming from the
   newest checkpoint (``--checkpoint_interval`` must divide every eval
   step); the trainer runs the hoisted step while ``hoist_force_eligible``
   and the scanned one from ``tf_start_decay`` on (the trainer logs no
   line for the switch; ``acoustic_loss.csv`` has its s/step per logged
   step, and ``hoist_force_eligible`` tells which step ran);
3. at each boundary: held-out teacher-forced losses (per-item masks) and
   free-running synthesis alignment metrics (argmax coverage against the
   0.95 bar, mass coverage, diagonality) with per-utterance rows kept for
   straggler diagnosis, on ``--device`` (one ``decode_full`` launch per
   text);
4. write an incremental ``decay_table.json`` + ``README.md`` to
   ``--out_dir`` (default under ``runs/torch_port/``), so that partial
   sessions still leave their evidence.

``--device`` defaults to ``cuda`` and raises without a card.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.decay_session \
      --out_dir runs/torch_port/decay --workdir /tmp/decay \
      --eval_steps 10000,14000,18000,22000,26000 [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re

import numpy as np

from ..config import Config
from .convergence_session import (ACOUSTIC_CLI, alignment_means, alignment_rows,
                                  eval_teacher_forced, parse_series, run_cli)
from .synth_corpus import build_corpus


def eval_synthesis_alignment(cfg: Config, data_dir: str, ac_run: str,
                             out_dir: str, vocoder_dir: str | None = None,
                             max_texts: int = 10, tag: str = '',
                             device='cuda') -> dict:
    """Free-running held-out synthesis -> alignment metrics per utterance.

    Unlike ``convergence_session.eval_synthesis`` this does not require a
    trained vocoder (alignment metrics are an acoustic-model property); when
    one IS given, the worst-coverage utterance is also rendered to wav for
    listening-based straggler diagnosis.
    """
    from ..audio import features as F
    from ..serve.pipeline import Synthesizer
    from ..utils.plotting import plot_alignment, save_figure

    synth = Synthesizer(cfg, acoustic_dir=ac_run, vocoder_dir=vocoder_dir, devices=[device])
    rows, aligns = alignment_rows(synth, data_dir, max_texts)
    if rows and tag:
        i = int(np.argmin([r['coverage'] for r in rows]))
        name, text, align = aligns[i]
        save_figure(plot_alignment, align, os.path.join(out_dir, f'align_worst_{tag}.png'),
                    info=f'{name} coverage={rows[i]["coverage"]:.3f} @{tag}')
        if vocoder_dir is not None:
            wav = synth.tts(text)
            F.save_wav(wav, os.path.join(out_dir, f'worst_{tag}_{name}.wav'), cfg.audio)
    return {**alignment_means(rows),
            'min_coverage': float(min(r['coverage'] for r in rows))}


def tf_ratio_at(step: int, hp) -> float:
    """Host-side mirror of ``schedules.teacher_forcing_ratio``."""
    if step < hp.tf_start_decay:
        return float(hp.tf_init)
    t = min(max(step - hp.tf_start_decay, 0), hp.tf_decay)
    return float(hp.tf_init * 0.5 * (1.0 + np.cos(np.pi * t / hp.tf_decay)))


def auto_buckets(data_dir: str, cfg: Config) -> tuple:
    """(frame_bucket, text_bucket) covering every corpus utterance, so that
    every batch of the run pads to ONE decode geometry.  Both are padding
    MULTIPLES; set to the (rounded-up) corpus max they collapse the shape
    space to a single (B, T_pad, N_pad)."""
    from ..data.feeder import AcousticDataset
    r = cfg.acoustic.outputs_per_step
    mxf = mxt = 0
    for split in ('train', 'test'):
        ds = AcousticDataset(data_dir, cfg, split)
        mxf = max(mxf, max(ds.frame_len(i) for i in range(len(ds))))
        mxt = max(mxt, max(ds.text_len(i) for i in range(len(ds))))
    fb = -(-(mxf + 1) // r) * r
    tb = -(-mxt // cfg.acoustic.text_bucket) * cfg.acoustic.text_bucket
    return fb, tb


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--out_dir', default='runs/torch_port/decay')
    p.add_argument('--workdir', required=True)
    p.add_argument('--n_utts', type=int, default=2600)
    p.add_argument('--n_speakers', type=int, default=6)
    p.add_argument('--min_syl', type=int, default=4)
    p.add_argument('--max_syl', type=int, default=16)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--tf_start_decay', type=int, default=10000)
    p.add_argument('--tf_decay', type=int, default=12000,
                   help='cosine decay LENGTH in steps (tf reaches 0 at '
                        'tf_start_decay + tf_decay, then trains free-running '
                        '-- the compressed mirror of the reference 20k->220k '
                        'over a 320k budget)')
    p.add_argument('--eval_steps', default='10000,14000,18000,22000,26000')
    p.add_argument('--checkpoint_interval', type=int, default=2000)
    p.add_argument('--vocoder_dir', default=None,
                   help='optional trained generator run dir: render the '
                        'worst-coverage utterance to wav at each eval point')
    p.add_argument('--max_texts', type=int, default=20)
    p.add_argument('--device_data', action='store_true', default=True,
                   help='device-resident corpus (data/device_data.py): one '
                        'upload, each batch gathered on the device')
    p.add_argument('--no_device_data', dest='device_data',
                   action='store_false')
    p.add_argument('--skip_train', action='store_true', default=False)
    p.add_argument('--redo', action='store_true', default=False,
                   help='re-evaluate steps already in decay_table.json '
                        '(e.g. the final checkpoint with --vocoder_dir set '
                        'for the listening wav)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None) -> dict:
    """The session; returns the decay table."""
    from ..serve.pipeline import resolve_device
    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = Config()
    os.makedirs(args.out_dir, exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)
    processed = os.path.join(args.workdir, 'processed')
    if os.path.exists(os.path.join(processed, 'train.txt')):
        data_dir = processed
    else:
        data_dir = build_corpus(args.workdir, cfg, args.n_utts,
                                n_speakers=args.n_speakers,
                                min_syl=args.min_syl, max_syl=args.max_syl)
    print(f'# corpus at {data_dir}', flush=True)

    fb, tb = auto_buckets(data_dir, cfg)
    acfg = dataclasses.replace(
        cfg, acoustic=dataclasses.replace(
            cfg.acoustic, batch_size=args.batch_size, frame_bucket=fb,
            text_bucket=tb,
            tf_start_decay=args.tf_start_decay, tf_decay=args.tf_decay))
    print(f'# frame_bucket {fb}, text_bucket {tb}, batch {args.batch_size}, '
          f'tf decay {args.tf_start_decay}..'
          f'{args.tf_start_decay + args.tf_decay}', flush=True)
    cfg_path = acfg.save(os.path.join(args.workdir, 'cfg'))
    ac_run = os.path.join(args.workdir, 'ac_run')

    table_path = os.path.join(args.out_dir, 'decay_table.json')
    table = json.load(open(table_path)) if os.path.exists(table_path) else {
        'recipe': {'batch_size': args.batch_size, 'frame_bucket': fb,
                   'text_bucket': tb,
                   'tf_start_decay': args.tf_start_decay,
                   'tf_decay': args.tf_decay, 'n_utts': args.n_utts,
                   'n_speakers': args.n_speakers,
                   'lr_schedule': 'reference Noam (1e-3 peak, 4k warmup), '
                                  'unscaled for the batch size'},
        'rows': []}
    done_steps = (set() if args.redo
                  else {r['step'] for r in table['rows']})

    csv_path = os.path.join(args.out_dir, 'acoustic_loss.csv')
    if not os.path.exists(csv_path):
        with open(csv_path, 'w') as fh:
            fh.write('step,s_per_step,loss,mel_loss,stop_loss,tfr\n')

    for target in [int(x) for x in args.eval_steps.split(',')]:
        if not args.skip_train:
            out = run_cli(
                ACOUSTIC_CLI,
                ['--data_dir', data_dir, '--log_path', ac_run,
                 '--config', cfg_path, '--max_steps', str(target),
                 '--log_interval', '20',
                 # histogram summaries pull the batch and gradients to the
                 # host; keep them sparse
                 '--summary_interval', '2000',
                 '--checkpoint_interval', str(args.checkpoint_interval),
                 '--rss_limit_gb', '95', '--device', args.device]
                + (['--device_data'] if args.device_data else []))
            steps = [int(x) for x in re.findall(r'step (\d+) \[', out)]
            spst = parse_series(out, r'\[(\d+\.\d+) s/step')
            loss = parse_series(out, r'loss (\d+\.\d+),')
            mel = parse_series(out, r'mel (\d+\.\d+)')
            stop = parse_series(out, r'stop (\d+\.\d+)')
            tfr = parse_series(out, r'tfr (\d+\.\d+)')
            with open(csv_path, 'a') as fh:
                for i in range(min(len(steps), len(loss), len(mel),
                                   len(stop), len(tfr), len(spst))):
                    fh.write(f'{steps[i]},{spst[i]},{loss[i]},{mel[i]},'
                             f'{stop[i]},{tfr[i]}\n')
            if steps:
                print(f'# segment -> step {steps[-1]}: loss {loss[-1]:.3f} '
                      f'tfr {tfr[-1]:.3f} ({spst[-1]:.3f} s/step)',
                      flush=True)
        if target in done_steps:
            continue
        tf = eval_teacher_forced(acfg, data_dir, ac_run, args.device)
        sy = eval_synthesis_alignment(acfg, data_dir, ac_run, args.out_dir,
                                      vocoder_dir=args.vocoder_dir,
                                      max_texts=args.max_texts,
                                      tag=str(target), device=args.device)
        row = {'step': target,
               'tf_ratio': round(tf_ratio_at(target, acfg.acoustic), 4),
               'held_out_mel_l1_item': tf['held_out_mel_l1_item'],
               'held_out_stop_ce_item': tf['held_out_stop_ce_item'],
               'held_out_prds_accuracy': tf.get('held_out_prds_accuracy'),
               'coverage': sy['mean_coverage'],
               'mass_coverage': sy['mean_mass_coverage'],
               'diagonality': sy['mean_diagonality'],
               'focus': sy['mean_focus'],
               'min_coverage': sy['min_coverage'],
               'per_utt': sy['per_utt']}
        table['rows'] = [r for r in table['rows'] if r['step'] != target]
        table['rows'].append(row)
        table['rows'].sort(key=lambda r: r['step'])
        with open(table_path, 'w') as fh:
            json.dump(table, fh, indent=2)
        _write_report(args, table)
        print(f"# eval @{target}: tf={row['tf_ratio']:.3f} "
              f"coverage={row['coverage']:.3f} "
              f"(min {row['min_coverage']:.3f}) "
              f"mass={row['mass_coverage']:.3f} "
              f"diag={row['diagonality']:.3f} "
              f"mel_l1={row['held_out_mel_l1_item']:.4f}", flush=True)
    print(f'# wrote {table_path}', flush=True)
    return table


def _write_report(args, table):
    rec = table['recipe']
    md = [
        '# Training through the teacher-forcing decay',
        '',
        'The reference anneals teacher forcing with a cosine decay inside the',
        "decode loop ('mix' mode: each step feeds a tf_ratio-weighted blend of",
        'ground truth and the previous prediction, reference',
        '`custom_decoder.py:106-151`).  This run compresses the reference',
        'schedule (20k->220k of a 320k budget) to the corpus scale',
        f"(decay {rec['tf_start_decay']}->{rec['tf_start_decay'] + rec['tf_decay']})"
        f" at batch {rec['batch_size']}, with the reference Noam rate",
        '(peak 1e-3, 4k warm-up) unscaled for the batch size.',
        '',
        'The train step switches from the hoisted-force step to the scanned',
        'step exactly at the decay boundary (`hoist_force_eligible`); see the',
        '`acoustic_loss.csv` s/step column for the measured cost of each',
        'regime.',
        '',
        '| step | tf ratio | argmax cov | min cov | mass cov | diagonality |'
        ' mel L1 (item) | stop CE | prds acc |',
        '|---|---|---|---|---|---|---|---|---|',
    ]
    for r in table['rows']:
        prds = r.get('held_out_prds_accuracy')
        md.append(
            f"| {r['step']} | {r['tf_ratio']:.3f} | **{r['coverage']:.3f}** |"
            f" {r['min_coverage']:.3f} | {r['mass_coverage']:.3f} |"
            f" {r['diagonality']:.3f} | {r['held_out_mel_l1_item']:.4f} |"
            f" {r['held_out_stop_ce_item']:.4f} |"
            f" {prds if prds is None else format(prds, '.3f')} |")
    md += ['',
           'Per-utterance alignment rows live in `decay_table.json`; the',
           'worst-coverage utterance at each eval point is drawn as',
           '`align_worst_<step>.png` where matplotlib is installed (and',
           'rendered to wav when a trained vocoder is passed via',
           '`--vocoder_dir`).', '']
    with open(os.path.join(args.out_dir, 'README.md'), 'w') as fh:
        fh.write('\n'.join(md))


if __name__ == '__main__':
    main()
