"""Acoustic model training CLI, ported from
``transtacos_retunegan_tpu/train/train_acoustic.py`` with the same flags.

The feeder thread (length-bucketed batches) and a thread that copies each
batch to the card (pinned memory, its own CUDA stream; ``--wire_dtype``
narrows the float32 arrays on the host, the step widens them on the card);
the hoisted train step while ``hoist_force_eligible`` and the scanned one
from the teacher-forcing decay on; a loss breakdown every
``--log_interval`` steps, the only point where the host waits for the
card, with the running max of the loss kept on the card in between (exit 1
when it exceeded 300 or was not finite); a host-memory guard (checkpoint
and exit 75 for a resume); ``ckpt_`` checkpoints and the eval dump (decoded
input, Griffin-Lim wavs, alignment and spectrogram plots where matplotlib
is installed) every ``--checkpoint_interval`` steps, resumed from on start;
TensorBoard scalars and histograms (``summary_stats``) where tensorboard is
installed; ``--profile_dir`` records a ``torch.profiler`` trace;
``--debug_nans`` checks every step's losses and gradients for finite values
(and so waits for the card each step).

Data parallelism (``parallel``): ``--num_devices N`` runs one process per
device, each on its share of every global batch, with the gradients
averaged before the clip; the command starts the N local processes itself,
or joins the group of a launcher (``torchrun --nproc_per_node N``) or of
``--coordinator``/``--num_processes``/``--process_id``.  Rank r trains on
``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``); rank 0 alone
writes logs, summaries, checkpoints and the eval dump.

Tensor parallelism: ``--model_parallel k`` (with ``--num_devices N > 1``;
ignored with one device) lays the N ranks out as N/k data shards times k
model ranks (``parallel.make_mesh``; a model group is k consecutive ranks
of one host).  The ranks of a model group train on the same rows, each
holding ``1/k`` of the leaves the JAX package's ``tp_param_specs`` shards
(the decoder cell's GRUs and input projection, the attention heads, the
posnet; biases replicate) and of their Adam moments, and the step is the
global batch's as with ``--model_parallel 1``.  Checkpoints hold the
gathered model (a one-process run resumes them, and the reverse); the eval
dump runs on a gathered model on rank 0 alone.

``--device_data`` keeps the whole corpus on the device
(``data/device_data.py``: one upload, each batch gathered there from its
indices, padded to the corpus-wide geometry with the batch's own loss
lengths); under ``--num_devices N`` each rank holds one block of it.  It
exits when the corpus does not fit the device's budget
(``device_data.fits_in_hbm``), and it is refused for a run whose ranks
may be on other hosts (``--coordinator``, a launcher across nodes), as
the JAX package refuses multi-host runs.
The model trains in float32 with TF32 off.  ``--device`` defaults to
``cuda`` and raises without a card.

Usage:
  python -m transtacos_retunegan_tpu_torch.train.train_acoustic \\
      --data_dir ~/Data/processed --log_path runs/acoustic [--num_devices 8]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import time

import numpy as np
import torch

from ..audio import transforms as T
from ..config import Config
from ..data import device_data as DD
from ..data.feeder import AcousticDataset, DataFeeder
from ..data.prefetch import device_batches
from ..eval.metrics import prds_accuracy
from ..models.layers import Draws
from ..parallel import (any_rank, check_model_parallel, current_shard, describe,
                        is_primary, join_group, join_mesh, replicate, shard_params_tp,
                        single_host, start_workers, tp_sharded)
from ..serve.pipeline import resolve_device
from ..text import frontend
from ..utils.logging import ValueWindow, get_logger, host_rss_gb
from . import checkpoint as ckpt
from .acoustic_step import (frozen_stats, hoist_force_eligible, init_state, local_model,
                            summary_stats, train_step, train_step_hoisted)

WIRE_DTYPES = {'float32': None, 'float16': torch.float16, 'bfloat16': torch.bfloat16}
EXPLODED = 300.0


def _refuse(args) -> None:
    check_model_parallel(args)
    if getattr(args, 'device_data', False) and not single_host(args):
        raise SystemExit('--device_data supports single-host runs (one or several '
                         'devices of this machine); runs with ranks on other hosts '
                         '(--coordinator, a launcher across nodes) stream through '
                         'the feeder')


def make_draws(seed: int, device: torch.device, shard=None) -> Draws:
    """The noise, dropout and teacher-forcing streams of a run, on
    ``device``, seeded from ``seed``, drawn under ``shard``."""
    gens = [torch.Generator(device=device).manual_seed(seed + i) for i in range(3)]
    return Draws(noise=gens[0], dropout=gens[1], tf=gens[2], shard=shard)


def _check_finite(losses, model, step: int) -> None:
    """``--debug_nans``: raise at the first step with a loss or a gradient
    that is not finite."""
    bad = [k for k, v in losses.items()
           if isinstance(v, torch.Tensor) and not bool(torch.isfinite(v).all())]
    bad += [n for n, p in model.named_parameters()
            if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise FloatingPointError(f'step {step}: not finite: {", ".join(bad)}')


def train(args) -> None:
    _refuse(args)
    if start_workers(train, args):
        return
    device = resolve_device(join_group(args, getattr(args, 'device', 'cuda')))
    mesh = join_mesh(args)
    cfg = Config.load(args.config) if args.config else Config()
    if mesh is not None and cfg.acoustic.batch_size % mesh.count:
        raise SystemExit(f'batch_size {cfg.acoustic.batch_size} not divisible by the '
                         f'{mesh.count} data shards (--num_devices / --model_parallel)')
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.log_path, exist_ok=True)
    if is_primary():
        cfg.save(args.log_path)
    logger = get_logger('acoustic', os.path.join(args.log_path, 'train.log'),
                        primary=is_primary())
    # every rank computes the summaries under the state's shard (the 'cb'
    # encoder's batch norm and the gradient norms are the global batch's);
    # rank 0 writes them
    summaries = importlib.util.find_spec('tensorboard') is not None
    sw = None
    if summaries and is_primary():
        from torch.utils.tensorboard import SummaryWriter
        sw = SummaryWriter(args.log_path)

    dataset = AcousticDataset(args.data_dir, cfg, getattr(args, 'train_split', 'train'))
    logger.info(f'dataset: {len(dataset)} examples')
    state = init_state(cfg, cfg.audio.randseed, device, current_shard())
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f'model params: {n_params:,}')
    if ckpt.restore_acoustic(args.log_path, state) is not None:
        logger.info(f'resumed from step {state.step}')
    replicate(state.model)
    layout = describe(mesh, cfg.acoustic.batch_size // (mesh.count if mesh else 1), 'rows',
                      args)
    if layout:
        logger.info(layout)
    if mesh is not None and mesh.model_count > 1:
        shard_params_tp(mesh, state.model, state.opt)
        held = sum(p.numel() for p in state.model.parameters())
        logger.info(f'tensor parallel: {len(tp_sharded(state.model))} leaves sharded '
                    f'{mesh.model_count} ways, {held:,} parameters on each rank')
    draws = make_draws(cfg.audio.randseed + 3 * state.step, device)

    feeder = None
    if getattr(args, 'device_data', False):
        batches = _resident_batches(args, cfg, dataset, state, device, logger)
    else:
        feeder = DataFeeder(dataset, cfg)
        feeder.start()
        batches = _streamed_batches(args, feeder, device, logger)

    time_window, loss_window = ValueWindow(100), ValueWindow(100)
    max_steps = args.max_steps or cfg.acoustic.max_steps
    step = state.step
    loss_max = None            # running max on the card since the last log
    prof = None
    last_t = time.time()
    try:
        for batch in batches:
            if step >= max_steps:
                break
            if args.profile_dir and step == args.profile_start and is_primary():
                prof = _start_profiler(device)
            step_fn = train_step_hoisted if hoist_force_eligible(cfg, step) else train_step
            state, losses = step_fn(cfg, state, batch, draws)
            step += 1
            if args.debug_nans:
                _check_finite(losses, state.model, step)
            if prof is not None and step >= args.profile_start + args.profile_steps:
                _stop_profiler(prof, args.profile_dir, logger)
                prof = None
            loss_max = (losses['loss'] if loss_max is None
                        else torch.maximum(loss_max, losses['loss']))

            if step % args.log_interval == 0:
                loss = float(losses['loss'])              # waits for the card
                now = time.time()
                time_window.append((now - last_t) / args.log_interval)
                last_t = now
                loss_window.append(loss)
                logger.info(
                    f'step {step} [{time_window.average:.3f} s/step, '
                    f'loss {loss:.4f}, avg {loss_window.average:.4f}, '
                    f"mel {float(losses['mel_loss']):.4f} mag {float(losses['mag_loss']):.4f} "
                    f"stop {float(losses['stop_token_loss']):.4f} "
                    f"tfr {float(losses['tfr']):.3f}]")
                lmax = float(loss_max)
                loss_max = None
                if lmax > EXPLODED or not np.isfinite(lmax):
                    logger.error(f'loss exploded to {lmax} within the last '
                                 f'{args.log_interval} steps (step {step}), aborting')
                    raise SystemExit(1)
                rss_limit = getattr(args, 'rss_limit_gb', 0)
                if rss_limit and any_rank(host_rss_gb() > rss_limit, device):
                    path = ckpt.save_acoustic(args.log_path, state, cfg.acoustic.max_ckpt)
                    logger.warning(f'host RSS {host_rss_gb():.1f} GiB over --rss_limit_gb '
                                   f'{rss_limit}; checkpointed to {path}, exiting 75 '
                                   'for resume')
                    raise SystemExit(75)

            if summaries and step % args.summary_interval == 0:
                # draws of their own, so that summaries leave the run's streams
                _summaries(cfg, state, batch, make_draws(step, device), sw, step, losses)

            if step % args.checkpoint_interval == 0:
                path = ckpt.save_acoustic(args.log_path, state, cfg.acoustic.max_ckpt)
                logger.info(f'saved checkpoint {path}')
                _dump_eval(cfg, state, batch, args.log_path, step, logger, sw)
                last_t = time.time()                  # exclude the eval dump
    finally:
        if feeder is not None:
            feeder.stop()
        batches.close()
        if prof is not None:
            _stop_profiler(prof, args.profile_dir, logger)
        if sw is not None:
            sw.close()
    logger.info(f'training complete at step {step}')


def _streamed_batches(args, feeder, device, logger):
    """The feeder's batches on ``device``: copied ahead on a side stream
    (``--prefetch``, ``--wire_dtype``) or one at a time."""
    wire = WIRE_DTYPES[getattr(args, 'wire_dtype', None) or 'float32']
    prefetch = getattr(args, 'prefetch', 2)
    if prefetch > 0:
        logger.info(f'prefetch depth {prefetch}'
                    + (f', wire dtype {wire}' if wire is not None else ''))
        return device_batches(feeder, device, prefetch, wire)
    if wire is not None:
        logger.warning('--wire_dtype has no effect: it applies only to the '
                       '--prefetch path')
    return ({k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
            for b in feeder)


def _resident_batches(args, cfg, dataset, state, device, logger):
    """``--device_data``: the corpus (this rank's block of it) uploaded
    once; batches gathered on the device from the plan's indices."""
    if not DD.fits_in_hbm(dataset, cfg, device=device):
        raise SystemExit(
            f'--device_data: padded corpus is '
            f'{DD.corpus_nbytes(dataset, cfg) / 2 ** 30:.1f} GiB, over the budget of '
            f'{DD.HBM_SHARE:.4f} of the device\'s '
            f'{DD.device_memory_bytes(device) / 2 ** 30:.1f} GiB; use the streaming '
            'feeder')
    t0 = time.time()
    sharded = state.shard is not None and state.shard.count > 1
    dd = (DD.ShardedDeviceResidentData(dataset, cfg, state.shard, device) if sharded
          else DD.DeviceResidentData(dataset, cfg, device))
    logger.info(f'device-resident corpus: {dd.nbytes() / 2 ** 30:.2f} GiB '
                f'({dd.n} x T{dd.t_pad} x N{dd.n_pad}'
                f'{f", block {state.shard.index} of {state.shard.count}" if sharded else ""}'
                f'), uploaded in {time.time() - t0:.1f}s')
    return iter(DD.DevicePump(dd, seed=cfg.audio.randseed))


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, profile_dir: str, logger) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'trace.json')
    prof.export_chrome_trace(path)
    logger.info(f'wrote profiler trace to {path}')


def _summaries(cfg, state, batch, draws, sw, step: int, losses) -> None:
    """Scalars, and the histograms of ``summary_stats`` (outputs against
    targets, gradient norms per parameter, prosody accuracy); ``sw`` None
    computes them only."""
    stats = summary_stats(cfg, state, batch, draws)
    if sw is None:
        return
    for k, v in losses.items():
        sw.add_scalar(f'train/{k}', float(v), step)
    sw.add_histogram('mel_outputs', stats['mel_outputs'].cpu().numpy(), step)
    sw.add_histogram('mel_targets', batch['mel_targets'].float().cpu().numpy(), step)
    sw.add_histogram('mag_outputs', stats['mag_outputs'].cpu().numpy(), step)
    sw.add_histogram('mag_targets', batch['mag_targets'].float().cpu().numpy(), step)
    gn = torch.stack(list(stats['grad_norms'].values())).cpu().numpy()
    sw.add_histogram('gradient_norm', gn, step)
    sw.add_scalar('train/max_gradient_norm', float(gn.max()), step)
    if stats['prds_out'] is not None:
        sw.add_scalar('train/prds_accuracy', prds_accuracy(
            batch['prds'].cpu().numpy(), stats['prds_out'].cpu().numpy(),
            batch['text_lengths'].cpu().numpy()), step)


def format_decode_dump(cfg, batch, out) -> list:
    """Checkpoint-time input decode (reference ``transtacos/train.py:102-121``):
    the first batch item's phone string, tone string, and -- in syl4 mode --
    ground-truth vs predicted prosody marks with masked accuracy.  Returns
    log lines.  ``batch``/``out`` hold numpy arrays."""
    n = int(batch['text_lengths'][0])
    seq = np.asarray(batch['text'][0][:n])
    lines = ['Input:',
             f"  text: {' '.join(frontend.deserialize(seq, cfg.acoustic.g2p))}"]
    if seq.ndim == 2:                       # syl4 [T, 2]: (phone id, tone)
        lines.append(f"  tone: {''.join(str(t) for t in seq[:, 1])}")
    if out.get('prds_out') is not None:
        prds_r = np.asarray(batch['prds'][0][:n])
        prds_o = np.asarray(out['prds_out'][0][:n])
        acc = prds_accuracy(prds_r[None], prds_o[None], np.asarray([n]))
        lines.append(f"  prds: {''.join(str(p) for p in prds_r)}")
        lines.append(f"  pred: {''.join(str(p) for p in prds_o)} "
                     f"(accuracy {acc:.3f})")
    return lines


@torch.no_grad()
def _dump_eval(cfg, state, batch, log_path, step, logger, sw):
    """Eval artifacts of the batch's first item, on rank 0 alone with a
    local model (gathered under tensor parallelism) and no shard, so that
    it makes no collective: the teacher-forced forward of this rank's rows
    (fixed noise and dropout seeds, batch statistics left as they were),
    the decoded input, Griffin-Lim wavs of target and predicted mag,
    alignment and spectrogram plots."""
    from ..audio import features as F
    model = local_model(cfg, state)        # every rank: a gather under TP
    if not is_primary():
        return
    device = batch['text'].device
    batch = {k: v.float() if v.dtype in (torch.float16, torch.bfloat16) else v
             for k, v in batch.items()}
    with frozen_stats(model):
        out = model(batch['text'], batch['text_lengths'], batch['prds'],
                    batch['spec_lengths'], batch['mel_targets'],
                    batch['f0_targets'], batch['c0_targets'], 1.0, train=True,
                    draws=make_draws(0, device))
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    out = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    for line in format_decode_dump(cfg, host, out):
        logger.info(line)
    mag_t = host['mag_targets'][0].T                 # [F-1, T]
    mag_p = out['mag_outputs'][0].T
    try:
        wav_t = T.inv_spec(mag_t, cfg.audio)
        wav_p = T.inv_spec(mag_p, cfg.audio)
        F.save_wav(wav_t, os.path.join(log_path, f'step-{step}-raw.wav'), cfg.audio)
        F.save_wav(wav_p, os.path.join(log_path, f'step-{step}-gen.wav'), cfg.audio)
        if sw is not None:
            sw.add_audio('raw', wav_t[None] / max(1e-5, np.abs(wav_t).max()),
                         step, cfg.audio.sample_rate)
            sw.add_audio('gen', wav_p[None] / max(1e-5, np.abs(wav_p).max()),
                         step, cfg.audio.sample_rate)
    except (FloatingPointError, ValueError) as e:   # GL on garbage early specs
        logger.info(f'eval audio dump skipped: {e!r}')
    align = out['alignments'][0]
    try:
        from ..utils.plotting import plot_alignment, plot_specs
        plot_alignment(align, os.path.join(log_path, f'step-{step}-align.png'),
                       info=f'step={step}')
        plot_specs([mag_t, mag_p, host['mel_targets'][0].T, out['mel_outputs'][0].T],
                   os.path.join(log_path, f'step-{step}-specs.png'),
                   titles=['mag target', 'mag pred', 'mel target', 'mel pred'])
    except ImportError:
        logger.info('eval plots skipped: matplotlib is not installed')
    if sw is not None:
        sw.add_image('alignment', align[None], step)
        sw.add_image('E_text_sim', out['E_text_sim'][None], step)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--log_path', required=True)
    p.add_argument('--config', default=None)
    p.add_argument('--max_steps', type=int, default=None)
    p.add_argument('--log_interval', type=int, default=10)
    p.add_argument('--summary_interval', type=int, default=500)
    p.add_argument('--checkpoint_interval', type=int, default=1000)
    p.add_argument('--train_split', default='train',
                   help="index name: 'train' or a voice bank like 'vbank_male'")
    p.add_argument('--num_devices', type=int, default=0,
                   help='data parallelism over N devices, one process each '
                        '(started here unless a launcher or --coordinator did)')
    p.add_argument('--model_parallel', type=int, default=1,
                   help='tensor parallelism: k ranks share each model (with '
                        '--num_devices N, k dividing N; ignored on one device)')
    p.add_argument('--coordinator', default=None,
                   help='host:port of rank 0 for a group started elsewhere')
    p.add_argument('--num_processes', type=int, default=None)
    p.add_argument('--process_id', type=int, default=None)
    p.add_argument('--rss_limit_gb', type=float, default=0,
                   help='checkpoint and exit 75 when host RSS exceeds this '
                        '(resume continues the run).  0 = off.')
    p.add_argument('--prefetch', type=int, default=2,
                   help='batches copied to the device ahead of the step (0: none)')
    p.add_argument('--wire_dtype', default=None, choices=sorted(WIRE_DTYPES),
                   help='narrow float32 arrays to 16 bits for the host->device '
                        'copy (the targets round to ~1e-3 relative; the math '
                        'stays float32).  --prefetch path only')
    p.add_argument('--device_data', action='store_true', default=False,
                   help='keep the corpus on the device (16-bit targets) and gather '
                        'each batch there (one block per rank under --num_devices); '
                        'single-host runs only')
    p.add_argument('--debug_nans', action='store_true', default=False,
                   help='check every step\'s losses and gradients for finite values')
    p.add_argument('--profile_dir', default=None,
                   help='write a torch.profiler trace of --profile_steps steps here')
    p.add_argument('--profile_start', type=int, default=20)
    p.add_argument('--profile_steps', type=int, default=10)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None):
    train(parser().parse_args(argv))


if __name__ == '__main__':
    main()
