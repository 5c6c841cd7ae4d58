"""The acoustic training corpus resident on the device, ported from
``transtacos_retunegan_tpu/data/device_data.py``: upload once, gather each
batch on the device.

The streaming feeder (``data/feeder.py``) pads every batch on the host and
copies it to the device each step.  ``DeviceResidentData`` pads every
example once to a single corpus-wide ``(t_pad, n_pad)`` geometry, stores
the spectrogram targets in 16 bits, uploads the whole corpus in one copy,
and assembles each step's batch on the device by ``index_select`` from an
int32 index vector: per-step host-to-device traffic drops from a batch of
spectrograms to ``4 * batch_size`` bytes of indices.

Batch semantics match ``feeder.prepare_batch`` (reference
``data.py:172-226``): spectrogram rows pad with their own sample minimum,
the stop-token pad is 1.0, and ``frame_loss_len``/``text_loss_len`` are
the batch's reference lengths (``round_up(max + 1, r)`` and the longest
text), computed on the device from the gathered lengths, so that the train
steps' losses cover the batch's own extent of the corpus-wide padding.
The plan mirrors ``DataFeeder``: shuffled epochs, groups of ``batch_size x
batches_per_group`` sorted by frame count, split into batches, batch order
and members shuffled.  Targets quantize to ~1e-3 relative in the 16-bit
store (as ``--wire_dtype float16``); the gather widens them to float32.

Under data parallelism ``ShardedDeviceResidentData`` (the counterpart of
the JAX package's ``MeshDeviceResidentData``) gives rank r of N block r of
the corpus (equal blocks, the last wrapped round to the first rows), so
the corpus's device memory divides by N; each rank runs the JAX package's
per-shard plan over its block (seed ``seed * 131 + r``) and the loss
lengths are the global batch's (a max over the ranks).  Corpora that do
not fit are the streaming feeder's job (``fits_in_hbm``).
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..parallel import Shard
from ..serve.pipeline import resolve_device
from .feeder import AcousticDataset, _round_up

HBM_SHARE = 9 / 16     # the JAX package's 9 GiB budget on a 16 GB chip


def _padded_geometry(dataset: AcousticDataset, cfg: Config) -> tuple:
    """Single corpus-wide (t_pad, n_pad) covering every example (+1 stop
    frame), rounded to the configured bucket multiples."""
    hp = cfg.acoustic
    r = hp.outputs_per_step
    mxf = max(dataset.frame_len(i) for i in range(len(dataset)))
    mxt = max(dataset.text_len(i) for i in range(len(dataset)))
    t_pad = _round_up(_round_up(mxf + 1, r), hp.frame_bucket)
    n_pad = _round_up(mxt, hp.text_bucket)
    return t_pad, n_pad


def corpus_nbytes(dataset: AcousticDataset, cfg: Config) -> int:
    """Bytes of the padded corpus in the 16-bit store (upload size ==
    device memory)."""
    t_pad, n_pad = _padded_geometry(dataset, cfg)
    n = len(dataset)
    freq = cfg.audio.n_freq - 1
    per = (t_pad * (cfg.audio.n_mel + freq + 1) * 2      # mel+mag+stop f16
           + t_pad * 2 * 4                               # f0, c0 int32
           + n_pad * 3 * 4)                              # text[,2], prds int32
    return n * per + n * 8


def device_memory_bytes(device) -> int:
    """The memory of ``device``: the card's ``total_memory``, or the host's
    physical memory for the CPU."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf('SC_PHYS_PAGES') * os.sysconf('SC_PAGE_SIZE')


def fits_in_hbm(dataset: AcousticDataset, cfg: Config,
                budget_bytes: Optional[int] = None, device='cuda') -> bool:
    """True when the 16-bit corpus fits the budget: by default the JAX
    package's share of the device's memory (9 GiB of a 16 GB chip, 9/16),
    which leaves room for the parameters, optimizer state and
    activations."""
    if budget_bytes is None:
        budget_bytes = int(HBM_SHARE * device_memory_bytes(device))
    return corpus_nbytes(dataset, cfg) <= budget_bytes


def _build_host_arrays(dataset: AcousticDataset, cfg: Config, store_dtype: str,
                       rows: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """Pad the examples ``rows`` (all by default) to the corpus-wide
    geometry with the reference pad semantics (sample-min spectrogram pad,
    stop pad 1.0)."""
    t_pad, n_pad = _padded_geometry(dataset, cfg)
    rows = list(range(len(dataset))) if rows is None else list(rows)
    sd = np.dtype(store_dtype)
    n = len(rows)
    freq = cfg.audio.n_freq - 1
    text = np.zeros((n, n_pad, 2), np.int32)
    prds = np.zeros((n, n_pad), np.int32)
    mel = np.zeros((n, t_pad, cfg.audio.n_mel), sd)
    mag = np.zeros((n, t_pad, freq), sd)
    f0 = np.zeros((n, t_pad), np.int32)
    c0 = np.zeros((n, t_pad), np.int32)
    stop = np.ones((n, t_pad), sd)                      # pad value 1.0
    tlen = np.zeros(n, np.int32)
    slen = np.zeros(n, np.int32)
    for i, j in enumerate(rows):
        seq, p, me, ma, f0q, c0q, st = dataset.load(j)
        tlen[i], slen[i] = len(seq), len(me)
        text[i, :len(seq)] = seq
        prds[i, :len(p)] = p
        mel[i] = me.min()                               # sample-min pad
        mag[i] = ma.min()
        mel[i, :len(me)] = me
        mag[i, :len(ma)] = ma
        f0[i, :len(f0q)] = f0q
        c0[i, :len(c0q)] = c0q
        stop[i, :len(st)] = st
    return {'text': text, 'prds': prds, 'mel': mel, 'mag': mag,
            'f0': f0, 'c0': c0, 'stop': stop,
            'text_lengths': tlen, 'spec_lengths': slen}


def _grouped_plan(rng: random.Random, n: int, spec_lengths: np.ndarray, bs: int,
                  bpg: int) -> Iterator[List[int]]:
    """``DataFeeder``'s plan over ``n`` examples: shuffled epochs, groups of
    ``bs * bpg`` sorted by frame count, batch order and members shuffled."""
    order = list(range(n))
    offset = n                          # trigger shuffle on first use
    while True:
        group = []
        for _ in range(bs * bpg):
            if offset >= n:
                offset = 0
                rng.shuffle(order)
            group.append(order[offset])
            offset += 1
        group.sort(key=lambda i: int(spec_lengths[i]))
        batches = [group[i:i + bs] for i in range(0, len(group), bs)]
        rng.shuffle(batches)
        for idxs in batches:
            rng.shuffle(idxs)
            yield idxs


class DeviceResidentData:
    """The whole corpus on ``device`` and the batch gather there."""

    def __init__(self, dataset: AcousticDataset, cfg: Config, device='cuda',
                 store_dtype: str = 'float16'):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.t_pad, self.n_pad = _padded_geometry(dataset, cfg)
        host = self._host_arrays(dataset, store_dtype)
        self.n = len(host['spec_lengths'])
        self._spec_lengths = host['spec_lengths']
        self.data = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def _host_arrays(self, dataset, store_dtype):
        return _build_host_arrays(dataset, self.cfg, store_dtype)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data.values())

    def _global_max(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The device batch of the int32 indices ``idx`` (their
        ``4 * len(idx)`` bytes are all that crosses to the device)."""
        idx = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(self.device)
        take = lambda k: self.data[k].index_select(0, idx)   # noqa: E731
        sl, tl = take('spec_lengths'), take('text_lengths')
        r = self.cfg.acoustic.outputs_per_step
        lens = self._global_max(torch.stack([sl.max(), tl.max()]))
        return {
            'text': take('text'), 'prds': take('prds'),
            'text_lengths': tl, 'spec_lengths': sl,
            'mel_targets': take('mel').float(), 'mag_targets': take('mag').float(),
            'f0_targets': take('f0'), 'c0_targets': take('c0'),
            'stop_token_targets': take('stop').float(),
            'frame_loss_len': (lens[0] + r) // r * r,
            'text_loss_len': lens[1],
        }

    def plan(self, seed: int = 114514,
             batches_per_group: Optional[int] = None) -> Iterator[np.ndarray]:
        """Endless index batches with ``DataFeeder``'s grouping."""
        bs = self.cfg.acoustic.batch_size
        rng = random.Random(seed)
        for idxs in _grouped_plan(rng, self.n, self._spec_lengths, bs,
                                  batches_per_group or bs):
            yield np.asarray(idxs, np.int32)


class ShardedDeviceResidentData(DeviceResidentData):
    """Data coordinate ``shard.index``'s block of the corpus on its
    device (the ranks of a model group hold the same block): the
    corpus wrapped to ``ceil(n / count) * count`` rows (the first rows
    again) and cut into ``shard.count`` equal blocks.  ``plan`` yields this
    rank's local indices into its block (``batch_size / count`` per
    batch) and the gather's loss lengths are maxima over the data group."""

    def __init__(self, dataset: AcousticDataset, cfg: Config, shard: Shard,
                 device='cuda', store_dtype: str = 'float16'):
        if cfg.acoustic.batch_size % shard.count:
            raise ValueError(f'batch_size {cfg.acoustic.batch_size} not divisible by '
                             f'{shard.count} shards')
        self.shard = shard
        n = len(dataset)
        self.blk = -(-n // shard.count)
        self.rows = [(shard.index * self.blk + i) % n for i in range(self.blk)]
        super().__init__(dataset, cfg, device, store_dtype)

    def _host_arrays(self, dataset, store_dtype):
        return _build_host_arrays(dataset, self.cfg, store_dtype, self.rows)

    def _global_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard.count > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.shard.data_group)
        return x

    def plan(self, seed: int = 114514,
             batches_per_group: Optional[int] = None) -> Iterator[np.ndarray]:
        """Endless local index batches: the JAX package's plan of shard
        ``index`` over its block (seed ``seed * 131 + index``)."""
        bs_local = self.cfg.acoustic.batch_size // self.shard.count
        rng = random.Random(seed * 131 + self.shard.index)
        for idxs in _grouped_plan(rng, self.blk, self._spec_lengths, bs_local,
                                  batches_per_group or self.cfg.acoustic.batch_size):
            yield np.asarray(idxs, np.int32)


class DevicePump:
    """The train loop's batch source: the next planned index batch,
    gathered on the device (``get_batch``, or iterate)."""

    def __init__(self, dd: DeviceResidentData, seed: int = 114514):
        self.dd = dd
        self._it = dd.plan(seed)

    def get_batch(self) -> Dict[str, torch.Tensor]:
        return self.dd.gather(next(self._it))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.get_batch()
