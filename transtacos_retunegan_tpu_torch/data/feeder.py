"""Acoustic-model training feeder with length bucketing, ported from
``transtacos_retunegan_tpu/data/feeder.py`` (numpy; the same batches for
the same seed).

Rebuild of the reference's ``DataFeeder`` thread + ``tf.FIFOQueue``
(``transtacos/data.py``): loads ``batch_size^2`` examples per group, sorts by
spectrogram frame count, splits into batches, shuffles batch order.  Padding
follows the reference exactly (text pad id 0, spec pad per-sample min, stop
pad 1.0, lengths +1 then rounded up to r) and is then extended to the
``text_bucket``/``frame_bucket`` multiples, so that few batch shapes occur.
A background thread keeps a bounded queue of numpy batches; iterating the
feeder yields them (``data/prefetch.py::device_batches`` copies them to
the card).

Under data parallelism every rank computes the same global batch plan
(same seed, same order, lengths read from the .npy headers) and loads only
its strided members of each global batch, padded to the global batch's
shapes and loss lengths, so that the ranks' batches concatenated in rank
order form one global batch.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import features as F
from ..config import Config
from ..parallel import data_shards
from ..text import frontend


def _round_up(x: int, m: int) -> int:
    return x if x % m == 0 else x + m - x % m


class AcousticDataset:
    """Loads + caches serialized examples from a preprocessed corpus dir."""

    def __init__(self, data_dir: str, cfg: Config, split: str = 'train'):
        self.cfg = cfg
        self.data_dir = data_dir
        with open(os.path.join(data_dir, f'{split}.txt'), encoding='utf-8') as fh:
            self.metadata = [ln.strip().split('|') for ln in fh if ln.strip()]
        self.cache: List[Optional[tuple]] = [None] * len(self.metadata)
        self._frame_len: List[Optional[int]] = [None] * len(self.metadata)
        self._text_len: List[Optional[int]] = [None] * len(self.metadata)

    def __len__(self):
        return len(self.metadata)

    def frame_len(self, index: int) -> int:
        """Spectrogram frame count without loading the example (the mel
        .npy header, through mmap): the batch plan sorts a whole group by
        it."""
        if self._frame_len[index] is None:
            if self.cache[index] is not None:
                self._frame_len[index] = int(self.cache[index][2].shape[0])
            else:
                name = self.metadata[index][0]
                m = np.load(os.path.join(self.data_dir, f'mel-{name}.npy'),
                            mmap_mode='r')
                self._frame_len[index] = int(m.shape[1])   # stored [M, T]
        return self._frame_len[index]

    def text_len(self, index: int) -> int:
        """Serialized text length without loading the features: every rank
        pads to the global batch's longest text."""
        if self._text_len[index] is None:
            if self.cache[index] is not None:
                self._text_len[index] = int(len(self.cache[index][0]))
            else:
                _, prds_str, text = self.metadata[index]
                seq, _ = frontend.serialize_train(
                    text, [int(d) for d in prds_str], self.cfg.acoustic.g2p)
                self._text_len[index] = int(len(seq))
        return self._text_len[index]

    def load(self, index: int) -> tuple:
        """(seq [T,2], prds [T], mel [T,M], mag [T,F-1], f0q [T], c0q [T], stop [T])
        -- reference ``data.py:102-170`` incl. the DC-bin drop."""
        if self.cache[index] is None:
            name, prds_str, text = self.metadata[index]
            seq, prds = frontend.serialize_train(
                text, [int(d) for d in prds_str], self.cfg.acoustic.g2p)
            mel = np.load(os.path.join(self.data_dir, f'mel-{name}.npy')).T
            mag = np.load(os.path.join(self.data_dir, f'mag-{name}.npy')).T
            f0 = np.load(os.path.join(self.data_dir, f'f0-{name}.npy'))
            c0 = np.load(os.path.join(self.data_dir, f'c0-{name}.npy'))
            mag = mag[:, 1:]                             # drop DC
            f0q = F.quantize_f0(f0, self.cfg.audio)
            c0q = F.quantize_c0(c0, self.cfg.audio)
            stop = np.zeros(mel.shape[0], np.float32)
            self.cache[index] = (seq, prds, mel.astype(np.float32),
                                 mag.astype(np.float32), f0q, c0q, stop)
        return self.cache[index]


def prepare_batch(examples: List[tuple], cfg: Config,
                  pad_to: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Pad a list of examples, in their order, into one batch (reference
    ``data.py:172-226``).  ``pad_to``: the reference padded lengths
    ``(n_ref, t_ref)`` of a larger global batch these examples belong to."""
    hp = cfg.acoustic
    r = hp.outputs_per_step

    text_lengths = np.asarray([len(e[0]) for e in examples], np.int32)
    spec_lengths = np.asarray([len(e[2]) for e in examples], np.int32)

    if pad_to is not None:
        n_ref, t_ref = pad_to
    else:
        # reference padded lengths: text to batch max; frames to batch
        # max + 1, rounded up to a multiple of r
        n_ref = int(text_lengths.max())
        t_ref = _round_up(int(spec_lengths.max()) + 1, r)
    # static-shape buckets on top (loss masks exclude the extra padding)
    n_pad = _round_up(n_ref, hp.text_bucket)
    t_pad = _round_up(t_ref, hp.frame_bucket)

    b = len(examples)
    text = np.zeros((b, n_pad, 2), np.int32)
    prds = np.zeros((b, n_pad), np.int32)
    mel = np.zeros((b, t_pad, cfg.audio.n_mel), np.float32)
    mag = np.zeros((b, t_pad, cfg.audio.n_freq - 1), np.float32)
    f0 = np.zeros((b, t_pad), np.int32)
    c0 = np.zeros((b, t_pad), np.int32)
    stop = np.ones((b, t_pad), np.float32)          # pad value 1.0

    for i, (seq, p, me, ma, f0q, c0q, st) in enumerate(examples):
        text[i, :len(seq)] = seq
        prds[i, :len(p)] = p
        mel[i] = me.min()                           # spec pad with sample min
        mag[i] = ma.min()
        mel[i, :len(me)] = me
        mag[i, :len(ma)] = ma
        f0[i, :len(f0q)] = f0q
        c0[i, :len(c0q)] = c0q
        stop[i, :len(st)] = st

    return {
        'text': text, 'text_lengths': text_lengths, 'prds': prds,
        'spec_lengths': spec_lengths, 'mel_targets': mel, 'mag_targets': mag,
        'f0_targets': f0, 'c0_targets': c0, 'stop_token_targets': stop,
        'frame_loss_len': np.asarray(t_ref, np.int32),
        'text_loss_len': np.asarray(n_ref, np.int32),
    }


class DataFeeder(threading.Thread):
    """Background batch producer (reference ``data.py:20-100``)."""

    def __init__(self, dataset: AcousticDataset, cfg: Config,
                 batches_per_group: Optional[int] = None, queue_size: int = 8,
                 seed: int = 114514, num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None):
        """``num_shards``/``shard_index``: this process's share of every
        global batch (its strided members); the data-axis size and this
        process's data coordinate by default (``parallel.data_shards``)."""
        super().__init__(daemon=True)
        self.dataset = dataset
        self.cfg = cfg
        self.bs = cfg.acoustic.batch_size
        self._order = list(range(len(dataset)))
        pc, pidx = data_shards()
        self._pc = pc if num_shards is None else num_shards
        self._pidx = pidx if shard_index is None else shard_index
        if self.bs % self._pc:
            raise ValueError(f'batch_size {self.bs} not divisible by {self._pc} shards')
        self.batches_per_group = batches_per_group or self.bs
        self.q: 'queue.Queue[Dict[str, np.ndarray]]' = queue.Queue(queue_size)
        self.rng = random.Random(seed)
        self._offset = len(self._order)   # trigger shuffle on first use
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None

    def _next_index(self) -> int:
        if self._offset >= len(self._order):
            self._offset = 0
            self.rng.shuffle(self._order)
        i = self._order[self._offset]
        self._offset += 1
        return i

    def run(self):
        # propagate feeder-thread failures to the training loop instead of
        # dying silently and letting get_batch() time out opaquely
        # (reference parity: transtacos/data.py:65-71)
        try:
            self._run()
        except BaseException as e:
            self._error = e

    def _run(self):
        r = self.cfg.acoustic.outputs_per_step
        while not self._stop.is_set():
            n = self.bs
            group = [self._next_index() for _ in range(n * self.batches_per_group)]
            # bucket by output frame count (reference ``data.py:90-95``);
            # the plan uses lengths only, so it is the same on every rank
            group.sort(key=self.dataset.frame_len)
            batches = [group[i:i + n] for i in range(0, len(group), n)]
            self.rng.shuffle(batches)
            for idxs in batches:
                if self._stop.is_set():
                    return
                if len(idxs) != n:
                    continue
                self.rng.shuffle(idxs)     # within-batch order
                # the global batch's padded lengths (reference formulas)
                n_ref = max(self.dataset.text_len(i) for i in idxs)
                t_ref = _round_up(max(self.dataset.frame_len(i) for i in idxs) + 1, r)
                examples = [self.dataset.load(i) for i in idxs[self._pidx::self._pc]]
                self.q.put(prepare_batch(examples, self.cfg, pad_to=(n_ref, t_ref)))

    def get_batch(self, timeout: float = 300.0) -> Dict[str, np.ndarray]:
        deadline = _time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise RuntimeError('DataFeeder thread failed') from self._error
            try:
                return self.q.get(timeout=min(1.0, max(
                    0.01, deadline - _time.monotonic())))
            except queue.Empty:
                if _time.monotonic() >= deadline:
                    raise

    def __iter__(self):
        """Batches until ``stop``."""
        while not self._stop.is_set():
            try:
                yield self.get_batch(timeout=1.0)
            except queue.Empty:
                continue

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
