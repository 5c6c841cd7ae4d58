"""Vocoder GAN training CLI, ported from
``transtacos_retunegan_tpu/train/train_vocoder.py`` with the same flags.

Threaded loader over the RAM-cached dataset; a thread copies each batch to
the card (pinned memory, ``non_blocking``, its own CUDA stream) while the
previous step runs; the GAN step (D x ``d_train_times``, then G); a loss
breakdown every ``--stdout_interval`` steps, the only point where the host
waits for the card, with the running max of ``loss_gen_all`` kept on the
card in between (exit 1 when it exploded); TensorBoard scalars, audio and
spectrograms where ``tensorboard``/``matplotlib`` are installed;
``g_``/``do_`` checkpoints, resumed from on start; a host-memory guard
(checkpoint and exit 75 for a resume); validation every interval.
``--finetune`` consumes the acoustic preprocessor's features.
``--gl_engine`` picks the Griffin-Lim engine of the loader's templates:
the native library (default) or numpy.

Data parallelism (``parallel``): ``--num_devices N`` runs one process per
device, each on ``batch_size / N`` examples of every global batch (a
disjoint stride of the shared shuffled order), with every update's
gradients averaged over the ranks; the command starts the N local
processes itself, or joins the group of a launcher (``torchrun``) or of
``--coordinator``/``--num_processes``/``--process_id``.  Rank r trains on
``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``); rank 0 alone
writes logs, summaries and checkpoints and validates (the eval step takes
no shard, so it makes no collective).  ``--model_parallel k`` (with
``--num_devices N > 1``; ignored with one device) is the JAX package's: the
mesh is N/k data shards times k ranks and every parameter is replicated,
so the k ranks of a model group load the same rows and compute the same
step, and the run is the ``--num_devices N/k`` run.  ``--device``
defaults to ``cuda`` and raises without a card.  At
``compute_dtype='float32'`` TF32 is turned off for matmuls and convs.

Usage:
  python -m transtacos_retunegan_tpu_torch.train.train_vocoder \\
      --data_dir ~/Data/processed --log_path runs/vocoder --finetune [--num_devices 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..audio import transforms as T
from ..config import Config
from ..data.prefetch import device_batches
from ..data.vocoder_data import VocoderDataset, VocoderLoader
from ..models.precision import resolve_dtype
from ..parallel import (any_rank, check_model_parallel, current_shard, describe,
                        is_primary, join_group, join_mesh, replicate, start_workers)
from ..serve.pipeline import resolve_device
from ..utils.logging import get_logger, host_rss_gb
from . import checkpoint as ckpt
from .vocoder_step import gan_eval_step, gan_train_step, init_gan_state


def _config(args) -> Config:
    cfg = Config.load(args.config) if args.config else Config()
    if getattr(args, 'compute_dtype', None):
        cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(
            cfg.vocoder, compute_dtype=args.compute_dtype))
    return cfg


def train(args) -> None:
    check_model_parallel(args)
    if start_workers(train, args):
        return
    device = resolve_device(join_group(args, getattr(args, 'device', 'cuda')))
    mesh = join_mesh(args)
    cfg = _config(args)
    hv = cfg.vocoder
    if mesh is not None and hv.batch_size % mesh.count:
        raise SystemExit(f'batch_size {hv.batch_size} not divisible by the {mesh.count} '
                         'data shards (--num_devices / --model_parallel)')
    if device.type == 'cuda' and resolve_dtype(hv.compute_dtype) is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(args.log_path, exist_ok=True)
    if is_primary():
        cfg.save(args.log_path)
    logger = get_logger('vocoder', os.path.join(args.log_path, 'rtg.log'),
                        primary=is_primary())
    sw = None
    if is_primary():
        try:
            from torch.utils.tensorboard import SummaryWriter
            sw = SummaryWriter(args.log_path)
        except ImportError:
            pass

    engine = getattr(args, 'gl_engine', 'native')
    trainset = VocoderDataset(getattr(args, 'train_split', 'train'),
                              args.data_dir, cfg, finetune=args.finetune, engine=engine)
    validset = VocoderDataset('test', args.data_dir, cfg, finetune=args.finetune,
                              limit=hv.valid_limit, engine=engine)
    logger.info(f'dataset: {len(trainset)} train / {len(validset)} valid')
    loader = VocoderLoader(trainset, hv.batch_size, shuffle=True,
                           num_workers=hv.num_workers)
    steps_per_epoch = max(1, len(loader))

    state = init_gan_state(cfg, cfg.audio.randseed, device, current_shard())
    noise = torch.Generator(device=device).manual_seed(cfg.audio.randseed)
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminators.parameters())
    logger.info(f'generator {hv.generator_ver}: {n_g:,} params; discs: {n_d:,}')

    restored, last_epoch = ckpt.restore_gan(args.log_path, state)
    if restored is not None:
        logger.info(f'resumed from step {state.step} epoch {last_epoch}')
        noise.manual_seed(cfg.audio.randseed + state.step)
    replicate(state.generator)
    replicate(state.discriminators)
    layout = describe(mesh, loader.bs, 'examples', args)
    if layout:
        logger.info(layout + (' (every parameter replicated)'
                              if mesh and mesh.model_count > 1 else ''))

    prefetch = getattr(args, 'prefetch', 2)
    step = state.step
    loss_max = None            # running max on the card since the last log
    last_t = time.time()
    for epoch in range(max(0, last_epoch), args.epochs):
        start_e = time.time()
        logger.info(f'>> Epoch {epoch + 1}')
        for batch in device_batches(loader, device, prefetch):
            state, m = gan_train_step(cfg, state, batch, noise, steps_per_epoch)
            step += 1
            loss_max = (m['loss_gen_all'] if loss_max is None
                        else torch.maximum(loss_max, m['loss_gen_all']))

            if step % args.stdout_interval == 0:
                v = {k: float(x) for k, x in m.items()}         # waits for the card
                now = time.time()
                s_per_b = (now - last_t) / args.stdout_interval
                last_t = now
                logger.info(
                    f'[{step} ({s_per_b:.2f} s/b)]\n'
                    f"  total gen: {v['loss_gen_all']:.3f}, g_s: {v['loss_gen_s']:.3f}, "
                    f"g_p: {v['loss_gen_p']:.3f}, g_t: {v['loss_gen_t']:.3f}, "
                    f"fm_s: {v['loss_fm_s'] * hv.w_loss_fm:.3f}, "
                    f"fm_p: {v['loss_fm_p'] * hv.w_loss_fm:.3f}, "
                    f"fm_t: {v['loss_fm_t'] * hv.w_loss_fm:.3f}, "
                    f"mstft: {v['loss_mstft'] * hv.w_loss_mstft:.3f}, "
                    f"dyn: {v['loss_dyn'] * hv.w_loss_dyn:.3f}\n"
                    f"  total disc: {v['loss_disc_all']:.3f}, "
                    f"d_s: {v['loss_disc_s']:.3f}, d_p: {v['loss_disc_p']:.3f}, "
                    f"d_t: {v['loss_disc_t']:.3f}\n"
                    f"  d-scores >> sc_s_r: {v['sc_s_r']:.3f}, sc_s_g: {v['sc_s_g']:.3f}, "
                    f"sc_p_r: {v['sc_p_r']:.3f}, sc_p_g: {v['sc_p_g']:.3f}, "
                    f"sc_t_r: {v['sc_t_r']:.3f}, sc_t_g: {v['sc_t_g']:.3f}")
                gmax = float(loss_max)
                loss_max = None
                if not np.isfinite(gmax) or gmax > 1e5:
                    logger.error(f'loss exploded to {gmax} within the last '
                                 f'{args.stdout_interval} steps, aborting')
                    raise SystemExit(1)
                rss_limit = getattr(args, 'rss_limit_gb', 0)
                if rss_limit and any_rank(host_rss_gb() > rss_limit, device):
                    paths = ckpt.save_gan(args.log_path, state, epoch)
                    logger.warning(f'host RSS {host_rss_gb():.1f} GiB over '
                                   f'--rss_limit_gb {rss_limit}; checkpointed '
                                   f'{paths}, exiting 75 for resume')
                    raise SystemExit(75)

            if sw is not None and step % args.summary_interval == 0:
                for k, x in m.items():
                    sw.add_scalar(f'train/{k}', float(x), step)

            if step % args.checkpoint_interval == 0:
                logger.info(f'saved {ckpt.save_gan(args.log_path, state, epoch)}')

            if step % args.validation_interval == 0 and is_primary():
                _validate(cfg, state, validset, step, logger, sw, device)
                last_t = time.time()                 # exclude validation time

        logger.info(f'<< Epoch {epoch + 1} took {time.time() - start_e:.2f}s')
    if sw is not None:
        sw.close()


def _pad_to_bucket(item, cfg, bucket_frames=128):
    """Pad a full-length eval item to a frame bucket, as the JAX CLI does
    (its validation metrics cover the padded length)."""
    hop = cfg.audio.hop_length
    t = item['mel'].shape[0] if 'mel' in item else item['mel_c'].shape[0]
    t_pad = -(-t // bucket_frames) * bucket_frames
    if t_pad == t:
        return item
    out = {}
    for k, v in item.items():
        if k.startswith('mel'):
            out[k] = np.pad(v, ((0, t_pad - t), (0, 0)),
                            constant_values=float(v.min()))
        else:
            out[k] = np.pad(v, (0, (t_pad - t) * hop))
    return out


def _validate(cfg, state, validset, step, logger, sw, device):
    """Held-out metrics and sample audio."""
    agg = {'loss_mstft': 0.0, 'loss_env': 0.0, 'loss_dyn': 0.0, 'loss_sm': 0.0}
    count = 0
    for j in range(len(validset)):
        item = _pad_to_bucket(validset[j], cfg)
        batch = {k: torch.from_numpy(v[None]).to(device) for k, v in item.items()}
        y_g, metrics = gan_eval_step(cfg, state.generator, batch)
        for k in agg:
            agg[k] += float(metrics[k])
        count += 1
        if sw is not None and j < 4:
            wav = y_g[0].cpu().numpy()
            sw.add_audio(f'gen/y_hat_{j}', wav[None] / max(1e-5, np.abs(wav).max()),
                         step, cfg.audio.sample_rate)
            try:
                from ..utils.plotting import spectrogram_figure
                sw.add_figure(f'gen/y_hat_spec_{j}',
                              spectrogram_figure(T.get_mel(wav, cfg.audio)), step)
            except ImportError:
                pass
            if step == 0:
                raw = item['wav']
                sw.add_audio(f'raw/y_{j}', raw[None] / max(1e-5, np.abs(raw).max()),
                             step, cfg.audio.sample_rate)
    if count:
        logger.info('  valid >> ' + ', '.join(f'{k}: {v / count:.4f}'
                                              for k, v in agg.items()))
        if sw is not None:
            for k, v in agg.items():
                sw.add_scalar(f'valid/{k}', v / count, step)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--log_path', default='rtg-logs')
    p.add_argument('--config', default=None)
    p.add_argument('--finetune', action='store_true', default=False)
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--stdout_interval', type=int, default=10)
    p.add_argument('--summary_interval', type=int, default=250)
    p.add_argument('--validation_interval', type=int, default=1000)
    p.add_argument('--checkpoint_interval', type=int, default=1000)
    p.add_argument('--train_split', default='train',
                   help="index name: 'train' or a voice bank like 'vbank_male'")
    p.add_argument('--num_devices', type=int, default=0,
                   help='data parallelism over N devices, one process each '
                        '(started here unless a launcher or --coordinator did)')
    p.add_argument('--model_parallel', type=int, default=1,
                   help='k ranks per data shard, every parameter replicated '
                        '(the --num_devices N/k run; ignored on one device)')
    p.add_argument('--coordinator', default=None,
                   help='host:port of rank 0 for a group started elsewhere')
    p.add_argument('--num_processes', type=int, default=None)
    p.add_argument('--process_id', type=int, default=None)
    p.add_argument('--rss_limit_gb', type=float, default=0,
                   help='checkpoint and exit 75 when host RSS exceeds this '
                        '(resume continues the run).  0 = off.')
    p.add_argument('--prefetch', type=int, default=2,
                   help='batches copied to the device ahead of the step')
    p.add_argument('--gl_engine', default='native', choices=T.ENGINES,
                   help="the loader's Griffin-Lim templates: the native library "
                        '(built from native/ttsdsp.cpp at first use) or numpy')
    p.add_argument('--debug_nans', action='store_true', default=False,
                   help='torch.autograd anomaly detection')
    p.add_argument('--compute_dtype', default=None,
                   choices=['float32', 'bfloat16'],
                   help='conv compute precision (overrides config); bfloat16 '
                        '= autocast with float32 master params')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def main(argv=None):
    train(parser().parse_args(argv))


if __name__ == '__main__':
    main()
