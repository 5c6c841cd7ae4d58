"""One process of an N-process data-parallel train step, through the
production helpers (``parallel``), after
``transtacos_retunegan_tpu/tools/multihost_smoke.py``.

Each process joins the group (``--coordinator``/``--num_processes``/
``--process_id``, or a launcher's ``RANK``/``WORLD_SIZE``), builds the same
seeded model, takes its ``process_shard`` of a fixed global batch (or its
strided members of the feeder's global batch with ``--data_dir``) and runs
one acoustic step (``--model acoustic``, the scanned step) or one GAN step
(``--model gan``).  It prints ``RESULT <loss>``: the loss averaged over the
ranks, the same on every rank and equal to a one-process run on the global
batch up to float32 summation order.  On one machine, on the CPU::

    python -m transtacos_retunegan_tpu_torch.tools.multihost_smoke \\
        --cpu --coordinator 127.0.0.1:29517 --num_processes 2 --process_id 0 &
    python -m transtacos_retunegan_tpu_torch.tools.multihost_smoke \\
        --cpu --coordinator 127.0.0.1:29517 --num_processes 2 --process_id 1

Without ``--cpu`` rank r runs on ``cuda:LOCAL_RANK`` over NCCL.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

GLOBAL_BATCH = 8
_SEED = 1234


def demo_config():
    """The tiny acoustic and vocoder configuration of the JAX tool."""
    from ..config import Config
    base = Config()
    return dataclasses.replace(
        base,
        acoustic=dataclasses.replace(
            base.acoustic, embed_depth=32, encoder_depth=32, decoder_depth=64,
            attention_depth=16, prenet_depths=(32,), posnet_depth=64,
            var_embed_depth=16, var_prednet_depth=16, prdsnet_depth=16,
            posenc_depth=8, batch_size=GLOBAL_BATCH),
        vocoder=dataclasses.replace(
            base.vocoder, upsample_initial_channel=32,
            multi_stft_params=((512, 256, 60),), msd_layers=1, mpd_periods=(3,),
            disc_width_mult=0.125, batch_size=GLOBAL_BATCH))


def make_demo_gan_batch(b: int = GLOBAL_BATCH, seg: int = 512):
    """Seeded global GAN batch (mel, Griffin-Lim template, target wav)."""
    rng = np.random.RandomState(_SEED)
    return {'mel': rng.randn(b, seg // 256, 80).astype(np.float32),
            'tmpl': (rng.randn(b, seg) * 0.1).astype(np.float32),
            'wav': (rng.randn(b, seg) * 0.1).astype(np.float32)}


def make_demo_batch(cfg, b: int = GLOBAL_BATCH, n: int = 12, t: int = 20):
    """Seeded global acoustic batch; every process builds the same one and
    keeps its ``process_shard`` rows."""
    from ..text.symbols import get_vocab_size
    rng = np.random.RandomState(_SEED)
    vocab = get_vocab_size()
    return {
        'text': np.stack([rng.randint(4, vocab, (b, n)),
                          rng.randint(0, 6, (b, n))], -1).astype(np.int64),
        'text_lengths': np.full(b, n, np.int64),
        'prds': rng.randint(0, 6, (b, n)).astype(np.int64),
        'spec_lengths': np.full(b, t, np.int64),
        'mel_targets': rng.randn(b, t, 80).astype(np.float32),
        'mag_targets': rng.randn(b, t, 1024).astype(np.float32),
        'f0_targets': rng.randint(0, cfg.audio.n_f0_bins, (b, t)).astype(np.int64),
        'c0_targets': rng.randint(0, 32, (b, t)).astype(np.int64),
        'stop_token_targets': np.zeros((b, t), np.float32),
        'frame_loss_len': np.asarray(t, np.int64),
        'text_loss_len': np.asarray(n, np.int64),
    }


def _local(batch, device):
    from ..parallel import process_shard
    sl = process_shard(GLOBAL_BATCH)
    return {k: torch.from_numpy(v[sl] if v.ndim else v).to(device) for k, v in batch.items()}


def run(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--coordinator', default=None, help='host:port of rank 0')
    ap.add_argument('--num_processes', type=int, default=None)
    ap.add_argument('--process_id', type=int, default=None)
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU with gloo collectives')
    ap.add_argument('--data_dir', default=None,
                    help='a preprocessed corpus: the real feeder under the group '
                         '(every rank plans the same global batch and loads its '
                         'strided members)')
    ap.add_argument('--model', choices=['acoustic', 'gan'], default='acoustic')
    args = ap.parse_args(argv)

    from ..parallel import (current_shard, local_device, maybe_initialize_distributed,
                            rank, replicate, world_size)
    device = torch.device('cpu') if args.cpu else local_device('cuda')
    maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                 device=device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    print(f'[p{rank()}] processes={world_size()} device={device}', flush=True)
    cfg = demo_config()

    if args.model == 'gan':
        from ..train.vocoder_step import gan_train_step, init_gan_state
        state = init_gan_state(cfg, 0, device, current_shard())
        replicate(state.generator)
        replicate(state.discriminators)
        noise = torch.Generator(device=device).manual_seed(42)
        state, m = gan_train_step(cfg, state, _local(make_demo_gan_batch(), device),
                                  noise, 10)
        val = float(m['loss_gen_all'])
    else:
        from ..train.acoustic_step import init_state, train_step
        from ..train.train_acoustic import make_draws
        if args.data_dir:
            from ..data.feeder import AcousticDataset, DataFeeder
            feeder = DataFeeder(AcousticDataset(args.data_dir, cfg, 'train'), cfg,
                                batches_per_group=2, seed=_SEED)
            feeder.start()
            try:
                batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                         for k, v in feeder.get_batch(timeout=180).items()}
            finally:
                feeder.stop()
        else:
            batch = _local(make_demo_batch(cfg), device)
        state = init_state(cfg, 0, device, current_shard())
        replicate(state.model)
        state, losses = train_step(cfg, state, batch, make_draws(42, device))
        val = float(losses['loss'])
    print(f'[p{rank()}] RESULT {val:.6f}', flush=True)
    return val


if __name__ == '__main__':
    run(sys.argv[1:])
