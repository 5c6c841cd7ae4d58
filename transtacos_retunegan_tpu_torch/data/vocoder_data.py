"""Vocoder dataset: (mel, Griffin-Lim template, target wav) triples,
ported from ``transtacos_retunegan_tpu/data/vocoder_data.py`` (the same
numpy code and seeds, so items are bit-identical to the JAX package's).

Per-utterance full-length tuples are computed once and cached in RAM;
scratch mode analyses (augmented) wavs directly, finetune mode consumes
the acoustic preprocessor's ``mag-*.npy`` features denormalized to natural
scale, with the template cached on disk beside them (a cache written by
one Griffin-Lim engine is read by the other, as in the JAX package).  The
template runs on the native library unless ``engine='numpy'`` is asked
for (``audio.transforms.inv_log_mag``).  Train-time access returns random
``segment_size`` crops.  ``VocoderLoader`` is a threaded
shuffling batch loader; under data parallelism each rank takes a disjoint
stride of the shared shuffled order and ``batch_size / world size``
examples per batch.
"""

from __future__ import annotations

import os
import queue
import threading
from random import Random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import features as F
from ..audio import transforms as T
from ..config import Config
from ..parallel import data_shards


class VocoderDataset:
    def __init__(self, split: str, data_dir: str, cfg: Config,
                 finetune: bool = False, limit: Optional[int] = None,
                 seed: int = 114514, train: Optional[bool] = None,
                 engine: str = 'native'):
        if engine not in T.ENGINES:
            raise ValueError(f'engine {engine!r} not in {T.ENGINES}')
        self.cfg = cfg
        self.engine = engine
        # any non-test index (train.txt, vbank_*.txt voice banks) trains
        # with augmentation/crops; override with ``train=`` if needed
        self.is_train = train if train is not None else split != 'test'
        self.finetune = finetune
        self.data_dir = data_dir
        with open(os.path.join(data_dir, 'wav_path.txt')) as fh:
            wav_path = fh.read().strip()
        with open(os.path.join(data_dir, f'{split}.txt'), encoding='utf-8') as fh:
            names = [ln.split('|')[0] for ln in fh if ln.strip()]
        if limit:
            names = names[:limit]
        self.names = names
        self.wav_fps = [os.path.join(wav_path, f'{n}.wav') for n in names]
        self.cache: List[Optional[Tuple]] = [None] * len(names)
        self.rng = np.random.RandomState(seed)
        self.crop_rng = Random(seed)

    def __len__(self):
        return len(self.names)

    def _build(self, index: int) -> Tuple:
        au = self.cfg.audio
        hv = self.cfg.vocoder
        wav_fp = self.wav_fps[index]

        if not self.finetune:
            wav = F.load_wav(wav_fp, au)
            if self.is_train:
                wav = F.augment_wav(wav, au, self.rng)     # aug once, freeze
            wav = F.align_wav(wav, au.hop_length)
            mag = T.get_mag(wav[:-1], au)                  # log |STFT| [F, T]
            mag_nat = np.exp(mag)
        else:
            # identical to the acoustic preprocessor (reference data.py:49-65)
            wav = F.load_wav(wav_fp, au)
            wav = F.trim_silence(wav, au)
            wav = F.align_wav(wav, au.hop_length)
            name = self.names[index]
            mag_norm = np.load(os.path.join(self.data_dir, f'mag-{name}.npy'))
            mag_nat = T.spec_to_natural_scale(mag_norm, au)
            mag = np.log(np.maximum(mag_nat, 1e-5))

        wavlen = len(wav)
        mel = np.log(np.maximum(T.mag_to_mel(mag_nat, au), 1e-5)).astype(np.float32)
        if self.is_train:
            mel_aug = F.augment_spec(mel, self.rng, rounds=5)
            mel = mel / 2 + mel_aug / 2                    # 50/50 blend

        # Griffin-Lim reference waveform (the RefineGAN template).  In
        # finetune mode the template is a deterministic function of the
        # stored features, so it disk-caches next to them: one precompute
        # serves every GAN run on the corpus (the cross-variant ranking
        # study launches a fresh process per generator).  Scratch mode
        # augments the source wav per-process and must recompute.
        cache_fp = None
        if self.finetune:
            cache_fp = os.path.join(
                self.data_dir,
                f'tmpl{au.gl_iters_vocoder}-{self.names[index]}.npy')
        wav_tmpl = None
        if cache_fp and os.path.exists(cache_fp):
            wav_tmpl = np.load(cache_fp)
            if len(wav_tmpl) != wavlen:
                wav_tmpl = None                            # stale geometry
        if wav_tmpl is None:
            wav_tmpl = T.inv_log_mag(mag, au, length=wavlen - 1, engine=self.engine)
            wav_tmpl = np.pad(wav_tmpl, (0, 1))
            if cache_fp:
                tmp = f'{cache_fp}.{os.getpid()}.tmp.npy'
                np.save(tmp, wav_tmpl)
                os.replace(tmp, cache_fp)                  # atomic publish
        if au.ref_wav == 'dy':                             # first difference
            ext = np.pad(wav_tmpl, (0, 1))
            wav_tmpl = (ext[1:] - ext[:-1]).astype(np.float32)

        if hv.split_cv:
            zcr = F.get_zcr(wav_tmpl[:-1], au)
            dyn = F.get_c0(wav_tmpl[:-1], au)
            uv = F.get_uv(zcr, dyn)
            uv_ex = np.repeat(uv, au.hop_length).astype(np.float32)
            tmpl_c = wav_tmpl * uv_ex
            tmpl_v = wav_tmpl * (1 - uv_ex)
            mel_min = mel.min()
            shift = mel - mel_min
            mel_c = shift * uv[None, :] + mel_min
            mel_v = shift * (1 - uv)[None, :] + mel_min
            assert len(dyn) == len(zcr) == mel.shape[1]
            assert len(wav) == len(wav_tmpl) == mel.shape[1] * au.hop_length
            return (mel, wav, mel_c, mel_v, tmpl_c, tmpl_v, uv_ex)

        assert len(wav) == len(wav_tmpl) == mel.shape[1] * au.hop_length
        return (mel, wav, wav_tmpl)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        au = self.cfg.audio
        hv = self.cfg.vocoder
        if self.cache[index] is None:
            self.cache[index] = self._build(index)
        data = self.cache[index]
        seg = au.segment_size
        fps = au.frames_per_segment

        if hv.split_cv:
            mel, wav, mel_c, mel_v, tmpl_c, tmpl_v, uv_ex = data
        else:
            mel, wav, wav_tmpl = data

        if self.is_train:
            mellen = mel.shape[1]
            if len(wav) > seg:
                cp = self.crop_rng.randint(0, mellen - fps - 1)
                sl_f = slice(cp, cp + fps)
                sl_s = slice(cp * au.hop_length, (cp + fps) * au.hop_length)
                if hv.split_cv:
                    mel_c, mel_v = mel_c[:, sl_f], mel_v[:, sl_f]
                    tmpl_c, tmpl_v = tmpl_c[sl_s], tmpl_v[sl_s]
                    wav, uv_ex = wav[sl_s], uv_ex[sl_s]
                else:
                    mel, wav, wav_tmpl = mel[:, sl_f], wav[sl_s], wav_tmpl[sl_s]
            else:
                padf = fps - mellen
                pads = seg - len(wav)
                if hv.split_cv:
                    mel_c = np.pad(mel_c, ((0, 0), (0, padf)),
                                   constant_values=mel.min())
                    mel_v = np.pad(mel_v, ((0, 0), (0, padf)),
                                   constant_values=mel.min())
                    tmpl_c = np.pad(tmpl_c, (0, pads))
                    tmpl_v = np.pad(tmpl_v, (0, pads))
                    wav = np.pad(wav, (0, pads))
                    uv_ex = np.pad(uv_ex, (0, pads))
                else:
                    mel = np.pad(mel, ((0, 0), (0, padf)),
                                 constant_values=mel.min())
                    wav = np.pad(wav, (0, pads))
                    wav_tmpl = np.pad(wav_tmpl, (0, pads))

        if hv.split_cv:
            return {'mel_c': mel_c.T.astype(np.float32),
                    'mel_v': mel_v.T.astype(np.float32),
                    'tmpl_c': tmpl_c.astype(np.float32),
                    'tmpl_v': tmpl_v.astype(np.float32),
                    'wav': wav.astype(np.float32),
                    'uv': uv_ex.astype(np.float32)}
        return {'mel': mel.T.astype(np.float32),      # [T, M] activations-last
                'tmpl': wav_tmpl.astype(np.float32),
                'wav': wav.astype(np.float32)}


class VocoderLoader:
    """Threaded shuffling batch loader over a VocoderDataset."""

    def __init__(self, dataset: VocoderDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 queue_size: int = 8, drop_last: bool = True, seed: int = 1,
                 num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None, engine: Optional[str] = None):
        """``num_shards``/``shard_index``: this process's share of the data
        (a disjoint stride of the shuffled order and ``batch_size /
        num_shards`` examples per batch); the data-axis size and this
        process's data coordinate by default (``parallel.data_shards``).
        ``engine``: the Griffin-Lim engine handed on to the dataset (None
        keeps the dataset's own)."""
        if engine is not None:
            if engine not in T.ENGINES:
                raise ValueError(f'engine {engine!r} not in {T.ENGINES}')
            dataset.engine = engine
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.queue_size = queue_size
        self.rng = Random(seed)
        pc, pidx = data_shards()
        self._pc = pc if num_shards is None else num_shards
        self._pidx = pidx if shard_index is None else shard_index
        if self._pc > 1:
            if self.bs % self._pc:
                raise ValueError(f'batch_size {self.bs} not divisible by '
                                 f'{self._pc} shards')
            self.bs //= self._pc

    def __len__(self):
        n = len(self.ds) // self._pc if self._pc > 1 else len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def __iter__(self):
        order = list(range(len(self.ds)))
        if self.shuffle:
            self.rng.shuffle(order)
        if self._pc > 1:
            # same seed on every process -> same global order -> disjoint
            # strided per-process slices.  Truncate to a multiple of the
            # process count FIRST: otherwise one rank gets an extra example
            # and (with an unlucky batch boundary) an extra batch, and its
            # extra gan_train_step would issue a cross-host all-reduce the
            # other ranks never join -> deadlocked epoch.
            order = order[:len(order) - len(order) % self._pc]
            order = order[self._pidx::self._pc]
        batches = [order[i:i + self.bs] for i in range(0, len(order), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]

        q: 'queue.Queue' = queue.Queue(self.queue_size)
        idx_q: 'queue.Queue' = queue.Queue()
        for i, b in enumerate(batches):
            idx_q.put((i, b))
        results = {}
        lock = threading.Lock()

        errors = []

        def worker():
            while True:
                try:
                    i, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.ds[j] for j in idxs]
                    batch = {k: np.stack([it[k] for it in items])
                             for k in items[0]}
                except BaseException as e:        # propagate, don't hang
                    with lock:
                        errors.append(e)
                    return
                with lock:
                    results[i] = batch

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        served = 0
        while served < len(batches):
            with lock:
                if errors:
                    # a dead worker would leave its batch index forever
                    # missing and spin this loop -- surface the cause
                    # (reference parity: transtacos/data.py:65-71 stops
                    # training on feeder exceptions)
                    raise RuntimeError(
                        'VocoderLoader worker failed') from errors[0]
                batch = results.pop(served, None)
            if batch is None:
                threading.Event().wait(0.005)
                continue
            yield batch
            served += 1
