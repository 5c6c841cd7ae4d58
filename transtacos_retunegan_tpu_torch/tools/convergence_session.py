"""Training-quality evidence session: train both models, then score the
trained checkpoints.

Port of ``transtacos_retunegan_tpu/tools/convergence_session.py``:

1. builds a text-conditional articulatory corpus (``tools/synth_corpus.py``)
   with a train/test split -- audio is a deterministic function of the
   syllable string, so the text->audio mapping is learnable;
2. trains the DEFAULT-dimension acoustic model and the RefineGAN_small GAN at
   the REFERENCE settings (``d_train_times=2``, no grad clip --
   ``retunegan/hparam.py:104-114``) through the port's trainer CLIs, as
   subprocesses on ``--device``;
3. evaluates the trained checkpoints on ``--device``:
   * held-out teacher-forced mel/mag L1 (generalization),
   * free-running synthesis of held-out texts through ``Synthesizer`` (one
     ``decode_full`` launch per text, one more for the listening wav) with
     an alignment-diagonality metric and an alignment figure,
   * the trained vocoder scored against the very Griffin-Lim template it was
     fed (pesq_proxy/MCD/mstft/SNR) -- RefineGAN's reason to exist is beating
     its own GL input (reference anchor ``retunegan/hparam.py:45-56``);
4. writes loss-curve CSVs, ``quality_eval.json`` and a markdown report to
   ``--out_dir`` (default under ``runs/torch_port/``).

``--device`` defaults to ``cuda`` and raises without a card.  Figures need
matplotlib; without it they are skipped and every number is still written.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.convergence_session \
      --out_dir runs/torch_port/convergence [--acoustic_steps 4000] \
      [--gan_steps 2500] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..config import Config
from .synth_corpus import build_corpus

ACOUSTIC_CLI = 'transtacos_retunegan_tpu_torch.train.train_acoustic'
VOCODER_CLI = 'transtacos_retunegan_tpu_torch.train.train_vocoder'


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or ``cpu``."""
    if torch.device(device).type != 'cuda':
        return 'cpu'
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_cli(module: str, cli_args: list, timeout: int = 14400,
            max_attempts: int = 12) -> str:
    """Run a train CLI, resuming across host-memory-guard exits.

    Long runs pass ``--rss_limit_gb``: the CLI checkpoints and exits 75 when
    host memory runs high, and this wrapper re-invokes it (resume from the
    newest checkpoint) until it completes.  The outputs of all attempts
    concatenate, so the stdout loss series stays parseable."""
    out_all = ''
    for _ in range(max_attempts):
        r = subprocess.run([sys.executable, '-m', module] + cli_args,
                           capture_output=True, text=True, timeout=timeout)
        out_all += r.stdout
        if r.returncode == 0:
            return out_all
        if r.returncode == 75:        # rss-guard handoff: resume
            print('# rss guard tripped; resuming from checkpoint', flush=True)
            continue
        print(r.stdout[-3000:])
        print(r.stderr[-3000:])
        raise SystemExit(f'{module} failed: exit {r.returncode}')
    raise SystemExit(f'{module}: exceeded {max_attempts} rss-guard resumes')


def parse_series(text: str, pattern: str):
    return [float(x) for x in re.findall(pattern, text)]


def downsample(xs, ys, n=40):
    if len(xs) <= n:
        return list(zip(xs, ys))
    idx = np.linspace(0, len(xs) - 1, n).astype(int)
    return [(xs[i], ys[i]) for i in idx]


def _read_csv(path):
    rows = [ln.split(',') for ln in open(path).read().strip().split('\n')[1:]]
    return [[float(x) for x in r] for r in rows]


def held_out_texts(data_dir: str):
    """(name, pinyin, prds) rows of the preprocessor's test split."""
    out = []
    with open(os.path.join(data_dir, 'test.txt'), encoding='utf-8') as fh:
        for line in fh:
            name, prds, text = line.strip().split('|')
            out.append((name, text, prds))
    return out


# ---------------------------------------------------------------------------
# trained-checkpoint evaluation
# ---------------------------------------------------------------------------

def item_masked_losses(out: dict, batch: dict, cfg: Config) -> dict:
    """Held-out losses masked per ITEM instead of per batch.

    ``compute_losses`` keeps the reference's batch-max mask
    (``frame_loss_len`` is a scalar, reference ``data.py:172-226``): fine for
    length-homogeneous training buckets, but a whole-split eval batch charges
    short items for hundreds of out-of-distribution pad-tail frames (stop
    target 1.0, spec pad min) that bucketed training never exercises.  Here
    each row is masked to its own ``round_up(len + 1, r)``.
    """
    r = cfg.acoustic.outputs_per_step
    t_pad = out['mel_outputs'].shape[1]
    per_len = -(-(batch['spec_lengths'] + 1) // r) * r            # [B]
    steps = torch.arange(t_pad, device=per_len.device)
    fmask = (steps[None, :] < per_len[:, None]).float()

    def mmean(x):
        per_frame = torch.mean(x, dim=-1) if x.dim() == 3 else x
        return torch.sum(per_frame * fmask) / torch.clamp(fmask.sum(), min=1.0)

    logits = out['stop_token_outputs']
    labels = batch['stop_token_targets']
    ce = (torch.clamp(logits, min=0) - logits * labels
          + torch.log1p(torch.exp(-torch.abs(logits))))
    return {'mel_l1': mmean(torch.abs(batch['mel_targets'] - out['mel_outputs'])),
            'mag_l1': mmean(torch.abs(batch['mag_targets'] - out['mag_outputs'])),
            'stop_ce': mmean(ce)}


def eval_draws(device):
    """The draws of the teacher-forced evaluation forward: the noise,
    dropout and teacher-forcing streams from ``torch.Generator``s seeded 0,
    1 and 2 on ``device`` (where the JAX tool passes ``PRNGKey(0)``,
    ``(1)`` and ``(2)``), the same in every evaluation."""
    from ..train.train_acoustic import make_draws
    return make_draws(0, torch.device(device))


@torch.no_grad()
def eval_teacher_forced(cfg: Config, data_dir: str, ac_run: str,
                        device='cuda') -> dict:
    """Held-out teacher-forced losses through the trained checkpoint: the
    model in train mode (dropout, noise, teacher forcing at ratio 1) with
    ``eval_draws``, its batch statistics left as they were."""
    from ..data.feeder import AcousticDataset, prepare_batch
    from ..eval.metrics import prds_accuracy
    from ..models.acoustic import compute_losses
    from ..train import checkpoint as ckpt
    from ..train.acoustic_step import frozen_stats, init_state

    # one batch holding the ENTIRE test split, each item exactly once.  (A
    # DataFeeder at cfg batch_size would wrap a split smaller than the batch
    # and silently average duplicated items.)
    dataset = AcousticDataset(data_dir, cfg, 'test')
    host = prepare_batch([dataset.load(i) for i in range(len(dataset))], cfg)
    state = init_state(cfg, 0, device)
    if ckpt.restore_acoustic(ac_run, state) is None:
        raise SystemExit(f'no acoustic checkpoint under {ac_run}')
    model = state.model
    dev = next(model.parameters()).device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    model.train()
    with frozen_stats(model):
        out = model(batch['text'], batch['text_lengths'], batch['prds'],
                    batch['spec_lengths'], batch['mel_targets'], batch['f0_targets'],
                    batch['c0_targets'], 1.0, train=True, draws=eval_draws(dev))
    losses = compute_losses(out, batch, cfg, model)
    # Per-ITEM masked losses alongside the reference-semantics ones (see
    # ``item_masked_losses``): the in-distribution quality signal.
    item = item_masked_losses(out, batch, cfg)
    # NOTE reference name swap: 'mel_loss' is the LINEAR-spec L1,
    # 'mag_loss' the mel L1 (models/acoustic.py::compute_losses)
    res = {'held_out_mel_l1': float(losses['mag_loss']),
           'held_out_mag_l1': float(losses['mel_loss']),
           'held_out_stop_ce': float(losses['stop_token_loss']),
           'held_out_mel_l1_item': float(item['mel_l1']),
           'held_out_mag_l1_item': float(item['mag_l1']),
           'held_out_stop_ce_item': float(item['stop_ce']),
           'n_test_items': len(dataset)}
    if out.get('prds_out') is not None:
        res['held_out_prds_accuracy'] = prds_accuracy(
            host['prds'], out['prds_out'].cpu().numpy(), host['text_lengths'])
    return res


def alignment_rows(synth, data_dir: str, max_texts: int):
    """Free-running synthesis of the first ``max_texts`` held-out texts:
    ``alignment_diagonality`` of each (with its name and frame count) and
    the ``(name, text, alignment)`` of each."""
    from ..eval.metrics import alignment_diagonality
    rows, aligns = [], []
    for name, text, _ in held_out_texts(data_dir)[:max_texts]:
        out = synth.synthesize_with_alignment(text)
        d = alignment_diagonality(out['alignment'])
        d['name'] = name
        d['n_frames'] = out['n_frames']
        rows.append(d)
        aligns.append((name, text, out['alignment']))
    return rows, aligns


def alignment_means(rows) -> dict:
    return {
        'per_utt': rows,
        'mean_diagonality': float(np.mean([r['diagonality'] for r in rows])),
        'mean_focus': float(np.mean([r['focus'] for r in rows])),
        'mean_coverage': float(np.mean([r['coverage'] for r in rows])),
        'mean_mass_coverage': float(np.mean([r['mass_coverage'] for r in rows])),
    }


def eval_synthesis(cfg: Config, data_dir: str, ac_run: str, vo_run: str,
                   out_dir: str, max_texts: int = 10, device='cuda') -> dict:
    """Free-running held-out synthesis: alignment diagonality + audio dump."""
    from ..audio import features as F
    from ..serve.pipeline import Synthesizer
    from ..utils.plotting import plot_alignment, save_figure

    synth = Synthesizer(cfg, acoustic_dir=ac_run, vocoder_dir=vo_run, devices=[device])
    rows, aligns = alignment_rows(synth, data_dir, max_texts)
    if rows:
        i = int(np.argmax([r['diagonality'] for r in rows]))
        save_figure(plot_alignment, aligns[i][2], os.path.join(out_dir, 'alignment_heldout.png'),
                    info=f'{aligns[i][0]} (held out), diagonality={rows[i]["diagonality"]:.3f}')
    # end-to-end audio through the full neural stack (proof of life)
    name, text, _ = held_out_texts(data_dir)[0]
    wav = synth.tts(text)
    F.save_wav(wav, os.path.join(out_dir, f'heldout_{name}.wav'), cfg.audio)
    return alignment_means(rows)


def eval_vocoder_vs_gl(cfg: Config, data_dir: str, vo_run: str,
                       max_items: int = 12, device='cuda') -> dict:
    """Score the trained vocoder against the GL template it was fed, both
    against ground truth, on held-out items.  The GAN earns its keep only if
    gan metrics beat template metrics."""
    from ..data.vocoder_data import VocoderDataset
    from ..eval.metrics import evaluate_pair
    from ..train import checkpoint as ckpt
    from ..train.train_vocoder import _pad_to_bucket
    from ..train.vocoder_step import gan_eval_step, init_gan_state

    ds = VocoderDataset('test', data_dir, cfg, finetune=True, limit=max_items)
    generator = init_gan_state(cfg, 0, device).generator
    if ckpt.restore_generator_params(vo_run, generator) is None:
        raise SystemExit(f'no generator checkpoint under {vo_run}')
    generator.eval()
    dev = next(generator.parameters()).device

    agg = {'gl': {}, 'gan': {}}
    for j in range(len(ds)):
        item = _pad_to_bucket(ds[j], cfg)
        batch = {k: torch.from_numpy(v[None]).to(dev) for k, v in item.items()}
        y_g, _ = gan_eval_step(cfg, generator, batch)
        n = len(ds[j]['wav'])
        y = ds[j]['wav']
        for tag, y_hat in (('gl', ds[j]['tmpl'][:n]),
                           ('gan', y_g[0].cpu().numpy()[:n])):
            for k, v in evaluate_pair(y, y_hat, cfg).items():
                agg[tag].setdefault(k, []).append(v)
    out = {tag: {k: float(np.mean(v)) for k, v in d.items()}
           for tag, d in agg.items()}
    out['n_items'] = len(ds)
    out['gan_beats_gl'] = bool(
        out['gan']['pesq_proxy'] >= out['gl']['pesq_proxy']
        and out['gan']['mcd'] <= out['gl']['mcd'])
    return out


# ---------------------------------------------------------------------------
# session driver
# ---------------------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--out_dir', default='runs/torch_port/convergence')
    p.add_argument('--acoustic_steps', type=int, default=4000)
    p.add_argument('--gan_steps', type=int, default=2500)
    p.add_argument('--n_utts', type=int, default=240)
    p.add_argument('--n_speakers', type=int, default=1,
                   help='>1 varies base f0 + formant scale across a speaker '
                        'bank (corpus variability vs D memorization)')
    p.add_argument('--min_syl', type=int, default=3)
    p.add_argument('--max_syl', type=int, default=9)
    p.add_argument('--frame_bucket', type=int, default=320,
                   help='acoustic padding multiple; must cover the longest '
                        'utterance (raise with --max_syl)')
    p.add_argument('--r1_gamma', type=float, default=0.0,
                   help='R1 gradient penalty weight for the GAN leg; 0 = '
                        'reference semantics.  The principled stabilizer '
                        'when the discriminators saturate on a small corpus '
                        '(they hit exact 1/0 LSGAN targets and the '
                        'adversarial gradient derails the generator).')
    p.add_argument('--compute_dtype', default='float32',
                   choices=['float32', 'bfloat16'],
                   help='vocoder conv precision for the GAN leg (bfloat16 = '
                        'autocast, models/precision.py)')
    p.add_argument('--generator_ver', default='RefineGAN_small',
                   help='generator registry entry for the GAN leg (the '
                        'cross-variant ranking study runs MelGAN / '
                        'MelGANRetune / HiFiGAN etc. through this)')
    p.add_argument('--gan_batch_size', type=int, default=0,
                   help='override vocoder batch size (0 = config default '
                        '16; the bs64 production-recipe leg passes 64)')
    p.add_argument('--skip_acoustic', action='store_true', default=False)
    p.add_argument('--skip_gan', action='store_true', default=False)
    p.add_argument('--skip_eval', action='store_true', default=False)
    p.add_argument('--workdir', default=None)
    p.add_argument('--max_texts', type=int, default=10,
                   help='held-out texts synthesized by the evaluation')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def session_config(cfg: Config, args) -> Config:
    """The session's config: ``--frame_bucket`` rounded up to a multiple of
    r (teacher-forced decode runs t_pad/r steps, so a non-multiple desyncs
    output frames from target frames) and the GAN leg's options."""
    r = cfg.acoustic.outputs_per_step
    fb = -(-args.frame_bucket // r) * r
    if fb != args.frame_bucket:
        print(f'# frame_bucket {args.frame_bucket} -> {fb} (multiple of r={r})',
              flush=True)
    return dataclasses.replace(
        cfg, acoustic=dataclasses.replace(cfg.acoustic, frame_bucket=fb),
        vocoder=dataclasses.replace(
            cfg.vocoder, r1_gamma=args.r1_gamma,
            compute_dtype=args.compute_dtype,
            generator_ver=args.generator_ver,
            **({'batch_size': args.gan_batch_size}
               if args.gan_batch_size else {})))


def main(argv=None) -> dict:
    """The session; returns ``quality_eval.json``'s content."""
    from ..serve.pipeline import resolve_device
    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = Config()
    base = args.workdir or tempfile.mkdtemp(prefix='convergence_')
    os.makedirs(args.out_dir, exist_ok=True)
    processed = f'{base}/processed'
    if os.path.exists(os.path.join(processed, 'train.txt')):
        data_dir = processed          # reuse when resuming inside a workdir
    else:
        data_dir = build_corpus(base, cfg, args.n_utts,
                                n_speakers=args.n_speakers,
                                min_syl=args.min_syl, max_syl=args.max_syl)
    print(f'# corpus at {data_dir}', flush=True)

    # Vocoder settings are the REFERENCE defaults (d_train_times=2, no grad
    # clip) -- committed-run evidence at exactly these settings.
    acfg = session_config(cfg, args)
    cfg_path = acfg.save(f'{base}/cfg')
    ac_run, vo_run = f'{base}/ac_run', f'{base}/vo_run'
    dev = ['--device', args.device]

    # ---- acoustic model, default dims, batch 16
    out = ''
    if not args.skip_acoustic:
        out = run_cli(
            ACOUSTIC_CLI,
            ['--data_dir', data_dir, '--log_path', ac_run,
             '--config', cfg_path,
             '--max_steps', str(args.acoustic_steps),
             '--log_interval', str(max(1, min(20, args.acoustic_steps // 10))),
             # checkpoint periodically (not only at the end): the rss-guard
             # resume path needs something to resume FROM
             '--checkpoint_interval', str(min(args.acoustic_steps, 2000)),
             '--rss_limit_gb', '95'] + dev)
    steps = [int(x) for x in re.findall(r'step (\d+) \[', out)]
    loss = parse_series(out, r'loss (\d+\.\d+),')
    mel = parse_series(out, r'mel (\d+\.\d+)')
    stop = parse_series(out, r'stop (\d+\.\d+)')
    acsv = os.path.join(args.out_dir, 'acoustic_loss.csv')
    if steps:
        with open(acsv, 'w') as fh:
            fh.write('step,loss,mel_loss,stop_loss\n')
            for i in range(min(len(steps), len(loss), len(mel), len(stop))):
                fh.write(f'{steps[i]},{loss[i]},{mel[i]},{stop[i]}\n')
        print(f'# acoustic: loss {loss[0]:.3f} -> {loss[-1]:.3f} '
              f'over {steps[-1]} steps', flush=True)
    elif os.path.exists(acsv):
        rows = _read_csv(acsv)
        steps = [int(r[0]) for r in rows]
        loss, mel, stop = ([r[i] for r in rows] for i in (1, 2, 3))

    # ---- vocoder GAN at reference settings
    out = ''
    if not args.skip_gan:
        steps_per_epoch = max(1, int(args.n_utts * 0.95)
                              // acfg.vocoder.batch_size)
        epochs = max(1, -(-args.gan_steps // steps_per_epoch))
        out = run_cli(
            VOCODER_CLI,
            ['--data_dir', data_dir, '--log_path', vo_run,
             '--config', cfg_path,
             '--finetune', '--epochs', str(epochs),
             '--stdout_interval', str(max(1, min(10, args.gan_steps // 10))),
             '--checkpoint_interval', str(min(args.gan_steps, 2000)),
             '--validation_interval', str(args.gan_steps),
             '--summary_interval', str(args.gan_steps),
             '--rss_limit_gb', '95'] + dev)
    gsteps = [int(x) for x in re.findall(r'\[(\d+) \(', out)]
    mstft = parse_series(out, r'mstft: (\d+\.\d+)')
    gen_all = parse_series(out, r'total gen: (\d+\.\d+)')
    sc_r = parse_series(out, r'sc_s_r: (-?\d+\.\d+)')
    sc_g = parse_series(out, r'sc_s_g: (-?\d+\.\d+)')
    gcsv = os.path.join(args.out_dir, 'gan_loss.csv')
    if gsteps:
        with open(gcsv, 'w') as fh:
            fh.write('step,gen_total,mstft_weighted,msd_score_real,msd_score_fake\n')
            for i in range(min(len(gsteps), len(mstft), len(gen_all),
                               len(sc_r), len(sc_g))):
                fh.write(f'{gsteps[i]},{gen_all[i]},{mstft[i]},{sc_r[i]},{sc_g[i]}\n')
        print(f'# gan: mstft(w) {mstft[0]:.3f} -> {mstft[-1]:.3f} '
              f'over {gsteps[-1]} steps', flush=True)
    elif os.path.exists(gcsv):
        rows = _read_csv(gcsv)
        gsteps = [int(r[0]) for r in rows]
        gen_all, mstft, sc_r, sc_g = ([r[i] for r in rows]
                                      for i in (1, 2, 3, 4))

    # ---- trained-checkpoint evaluation
    ev = {}
    qpath = os.path.join(args.out_dir, 'quality_eval.json')
    if not args.skip_eval:
        # each eval leg needs its model's run dir -- tolerate partial
        # sessions (e.g. a GAN-only leg run with --skip_acoustic)
        if os.path.isdir(ac_run):
            ev['teacher_forced'] = eval_teacher_forced(acfg, data_dir, ac_run, args.device)
            print(f"# teacher-forced held-out: {ev['teacher_forced']}", flush=True)
            if os.path.isdir(vo_run):
                ev['synthesis'] = eval_synthesis(acfg, data_dir, ac_run, vo_run,
                                                 args.out_dir, args.max_texts, args.device)
                print(f"# synthesis: diagonality="
                      f"{ev['synthesis']['mean_diagonality']:.3f} "
                      f"focus={ev['synthesis']['mean_focus']:.3f}", flush=True)
        if os.path.isdir(vo_run):
            ev['vocoder_vs_gl'] = eval_vocoder_vs_gl(acfg, data_dir, vo_run,
                                                     device=args.device)
            print(f"# vocoder vs GL: {ev['vocoder_vs_gl']}", flush=True)
        # only write when something was evaluated: an all-skipped session
        # must not clobber an earlier quality_eval.json with {}
        if ev:
            with open(qpath, 'w') as fh:
                json.dump(ev, fh, indent=2)
    elif os.path.exists(qpath):
        ev = json.load(open(qpath))

    _write_report(args, steps, loss, mel, stop, gsteps, gen_all, mstft, sc_r, sc_g, ev)
    print(f'# wrote {args.out_dir}/README.md + CSVs', flush=True)
    return ev


def _write_report(args, steps, loss, mel, stop,
                  gsteps, gen_all, mstft, sc_r, sc_g, ev):
    md = [
        '# Training-quality evidence (trained checkpoints)',
        '',
        f'Device: **{device_line(args.device)}**. Text-conditional articulatory corpus',
        f'(`tools/synth_corpus.py`, {args.n_utts} utterances, 5% held out),',
        'DEFAULT model dims, batch 16, reference schedules.  The GAN leg runs',
        'at the REFERENCE settings: `d_train_times=2`, no gradient clipping',
        '(`retunegan/hparam.py:104-114`).  Absolute losses are not comparable',
        "to the reference's DataBaker anchors (different data); held-out",
        'alignment/quality metrics below are the end-to-end evidence.',
        '',
        '## Acoustic model (TransTacoS)',
        '',
        '| step | total loss | mel L1 | stop CE |',
        '|---|---|---|---|',
    ]
    for (s, l), (_, m), (_, st) in zip(downsample(steps, loss, 20),
                                       downsample(steps, mel, 20),
                                       downsample(steps, stop, 20)):
        md.append(f'| {s} | {l:.3f} | {m:.3f} | {st:.4f} |')
    md += [
        '',
        '## Vocoder GAN (RefineGAN_small + MSD/MPD/MTD, reference settings)',
        '',
        '| step | G total | mstft (w=8) | MSD score real | MSD score fake |',
        '|---|---|---|---|---|',
    ]
    for (s, g), (_, m), (_, r_), (_, g_) in zip(
            downsample(gsteps, gen_all, 20), downsample(gsteps, mstft, 20),
            downsample(gsteps, sc_r, 20), downsample(gsteps, sc_g, 20)):
        md.append(f'| {s} | {g:.3f} | {m:.3f} | {r_:.3f} | {g_:.3f} |')

    if ev:
        nan = float('nan')
        tf = ev.get('teacher_forced', {})
        sy = ev.get('synthesis', {})
        vg = ev.get('vocoder_vs_gl', {})
        md += [
            '',
            '## Held-out evaluation (trained checkpoints)',
            '',
            f"Teacher-forced on the {tf.get('n_test_items', '?')}-utterance "
            'test split:',
            '',
            f"* per-item masks: mel L1 "
            f"**{tf.get('held_out_mel_l1_item', nan):.4f}**, "
            f"linear-spec L1 {tf.get('held_out_mag_l1_item', nan):.4f}, "
            f"stop CE {tf.get('held_out_stop_ce_item', nan):.4f}",
            f"* reference batch-max masks: mel L1 "
            f"{tf.get('held_out_mel_l1', nan):.4f}, "
            f"linear-spec L1 {tf.get('held_out_mag_l1', nan):.4f}, "
            f"stop CE {tf.get('held_out_stop_ce', nan):.4f}",
            '',
            'The reference masks losses to the BATCH-max frame length, so this',
            'whole-split eval batch charges short items for hundreds of',
            'out-of-distribution pad-tail frames that length-homogeneous',
            'training buckets never exercise — the per-item numbers are the',
            'in-distribution quality signal (`item_masked_losses` docstring).',
            '',
            'Free-running synthesis of held-out texts through `Synthesizer`',
            '(alignment metrics per `eval/metrics.py::alignment_diagonality`;',
            'see `alignment_heldout.png` where matplotlib is installed):',
            '',
            '| utterance | diagonality | focus | coverage | mass cov. | frames |',
            '|---|---|---|---|---|---|',
        ]
        for r in sy.get('per_utt', []):
            md.append(f"| {r['name']} | {r['diagonality']:.3f} | "
                      f"{r['focus']:.3f} | {r['coverage']:.3f} | "
                      f"{r.get('mass_coverage', nan):.3f} | "
                      f"{r['n_frames']} |")
        md += [
            f"| **mean** | **{sy.get('mean_diagonality', nan):.3f}** | "
            f"{sy.get('mean_focus', nan):.3f} | "
            f"{sy.get('mean_coverage', nan):.3f} | "
            f"{sy.get('mean_mass_coverage', nan):.3f} | |",
            '',
            '### Trained vocoder vs its own Griffin-Lim template (held out)',
            '',
            'Both scored against ground truth; the GAN must beat the template',
            'it was fed (reference anchor `retunegan/hparam.py:45-56`):',
            '',
            '| signal | pesq_proxy ↑ | MCD ↓ | mstft ↓ | SNR dB ↑ |',
            '|---|---|---|---|---|',
        ]
        for tag, label in (('gl', 'GL template (input)'),
                           ('gan', 'RefineGAN output')):
            d = vg.get(tag, {})
            md.append(f"| {label} | {d.get('pesq_proxy', nan):.3f} | "
                      f"{d.get('mcd', nan):.3f} | "
                      f"{d.get('mstft', nan):.3f} | "
                      f"{d.get('snr_db', nan):.2f} |")
        md += ['', f"**GAN beats GL: {vg.get('gan_beats_gl', '?')}** "
               f"(n={vg.get('n_items', '?')})", '',
               'Time-domain SNR is phase-blind-hostile: a GAN vocoder',
               're-synthesizes phase, so SNR can regress while every',
               'spectral metric improves.  Judge on pesq_proxy/MCD/mstft',
               '(`eval/metrics.py::snr_db`).']
    md.append('')
    with open(os.path.join(args.out_dir, 'README.md'), 'w') as fh:
        fh.write('\n'.join(md))


if __name__ == '__main__':
    main()
