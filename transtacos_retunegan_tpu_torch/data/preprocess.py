"""Corpus preprocessing: wav -> (mel, mag, f0, c0) features + metadata files.

A copy of ``transtacos_retunegan_tpu/data/preprocess.py`` (numpy; the same
files bit for bit), which rebuilds ``transtacos/preprocess.py`` +
``transtacos/datasets/databaker.py``:
parses the DataBaker prosody-labeling file, extracts per-utterance features in
a process pool, applies 2-sigma length filtering, and writes the same on-disk
contract both trainers consume:

  train.txt / test.txt   pipe-separated ``name|prds|text`` (5% test split)
  stats.txt              aggregated corpus statistics
  wav_path.txt           location of the source wavs
  {mel,mag}-<name>.npy   [M/F, T] normalized spectra; f0-/c0-<name>.npy [T]

Also includes a generic skeleton preprocessor (``datasets/__skel__.py``
equivalent) driven by a simple ``metadata.csv`` with ``name|pinyin|prds``
rows, so new corpora only need a label parser.

CLI:  python -m transtacos_retunegan_tpu_torch.data.preprocess \
          --base_dir ~/Data --dataset databaker --out_dir DataBaker.tts_processed
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from multiprocessing import get_context
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio import features as F
from ..audio import transforms as T
from ..config import AudioConfig, Config

DROPOUT_2SIGMA = True
PUNCT_KANJI_REGEX = re.compile(r'，|。|、|：|；|？|！|（|）|“|”|…|—')


def parse_databaker_labels(fp: str) -> Dict[str, Tuple[str, str]]:
    """DataBaker ProsodyLabeling format -> {name: (pinyin, prosody_digits)}.

    Prosody marks #0-#4 (word-internal .. sentence-final) attach to the
    preceding syllable (reference ``databaker.py:127-159``).
    """
    r = {}
    with open(fp, encoding='utf-8') as fh:
        while True:
            name_kanji = fh.readline().strip()
            if not name_kanji:
                break
            name, kanji = name_kanji.split('\t')
            pinyin = fh.readline().strip().lower()
            kanji = PUNCT_KANJI_REGEX.sub('', kanji)
            prosody: List[str] = []
            for k in kanji:
                if k == '#':
                    continue
                if k.isdigit():
                    if prosody:
                        prosody[-1] = k
                    else:
                        prosody.append(k)
                else:
                    prosody.append('0')
            r[name] = (pinyin, ''.join(prosody))
    return r


def make_metadata(name: str, feats: Tuple[str, str], wav_fp: str, out_dp: str,
                  cfg: AudioConfig) -> Optional[Tuple]:
    """Per-utterance feature extraction (reference ``databaker.py:94-124``)."""
    if not os.path.exists(wav_fp):
        return None
    text, prds = feats
    len_text = len(text.split(' '))
    if len_text != len(prds):
        return None

    y = F.load_wav(wav_fp, cfg)
    y = F.trim_silence(y, cfg)
    y = F.align_wav(y, cfg.hop_length)
    len_wav = len(y)
    if len_wav < cfg.hop_length * 4:
        return None

    y_cut = y[:-1]
    mag, mel = T.get_specs(y_cut, cfg)     # [F, T], [M, T]
    f0 = F.get_f0(y_cut, cfg)
    c0 = F.get_c0(y_cut, cfg)
    len_spec = mel.shape[1]
    assert len_wav == len_spec * cfg.hop_length

    np.save(os.path.join(out_dp, f'mel-{name}.npy'), mel, allow_pickle=False)
    np.save(os.path.join(out_dp, f'mag-{name}.npy'), mag, allow_pickle=False)
    np.save(os.path.join(out_dp, f'f0-{name}.npy'), f0, allow_pickle=False)
    np.save(os.path.join(out_dp, f'c0-{name}.npy'), c0, allow_pickle=False)

    stats = {
        'max_mel': mel.max(), 'min_mel': mel.min(),
        'max_mag': mag.max(), 'min_mag': mag.min(),
        'max_f0': f0.max(), 'min_f0': f0.min(),
        'max_c0': c0.max(), 'min_c0': c0.min(),
    }
    return (name, prds, text, len_text, len_wav, len_spec, stats)


def filter_2sigma(metadata: List[Tuple]) -> List[Tuple]:
    """Keep samples within 2 sigma on text and spec lengths
    (reference ``databaker.py:41-57``)."""
    tlens = np.asarray([mt[3] for mt in metadata])
    alens = np.asarray([mt[5] for mt in metadata])
    tl, tr = tlens.mean() - 2 * tlens.std(), tlens.mean() + 2 * tlens.std()
    al, ar = alens.mean() - 2 * alens.std(), alens.mean() + 2 * alens.std()
    return [mt for mt in metadata
            if tl <= mt[3] <= tr and al <= mt[5] <= ar]


def aggregate_stats(metadata: List[Tuple], cfg: AudioConfig) -> Dict[str, float]:
    len_text = np.asarray([mt[3] for mt in metadata])
    len_wav = np.asarray([mt[4] for mt in metadata])
    len_spec = np.asarray([mt[5] for mt in metadata])
    agg = defaultdict(list)
    for mt in metadata:
        for k, v in mt[6].items():
            agg[k].append(v)
    stats = {
        'total_examples': len(metadata),
        'total_hours': len_wav.sum() / cfg.sample_rate / 3600,
        'min_len_txt': len_text.min(), 'max_len_txt': len_text.max(),
        'avg_len_txt': len_text.mean(),
        'min_len_wav': len_wav.min(), 'max_len_wav': len_wav.max(),
        'avg_len_wav': len_wav.mean(),
        'min_len_spec': len_spec.min(), 'max_len_spec': len_spec.max(),
        'avg_len_spec': len_spec.mean(),
    }
    for k, v in agg.items():
        fn = k[:k.find('_')]
        stats[k] = getattr(np.asarray(v), fn)()
    return stats


def write_metadata(metadata: List[Tuple], stats: Dict, wav_dp: str,
                   out_dp: str, test_frac: float = 0.05) -> None:
    """train/test split + index files (reference ``preprocess.py:16-41``)."""
    rows = [f'{mt[0]}|{mt[1]}|{mt[2]}' for mt in metadata]
    n_test = max(1, int(len(rows) * test_frac))
    with open(os.path.join(out_dp, 'train.txt'), 'w', encoding='utf-8') as fh:
        fh.write('\n'.join(rows[:-n_test]) + '\n')
    with open(os.path.join(out_dp, 'test.txt'), 'w', encoding='utf-8') as fh:
        fh.write('\n'.join(rows[-n_test:]) + '\n')
    with open(os.path.join(out_dp, 'stats.txt'), 'w') as fh:
        for k, v in stats.items():
            fh.write(f'{k}: {v}\n')
    with open(os.path.join(out_dp, 'wav_path.txt'), 'w') as fh:
        fh.write(wav_dp + '\n')


def preprocess_databaker(base_dir: str, out_dir: str, num_workers: int = 4,
                         cfg: Optional[Config] = None) -> Dict:
    cfg = cfg or Config()
    wav_dp = os.path.join(base_dir, 'DataBaker', 'Wave')
    out_dp = os.path.join(base_dir, out_dir)
    os.makedirs(out_dp, exist_ok=True)
    labels = parse_databaker_labels(
        os.path.join(base_dir, 'DataBaker', 'ProsodyLabeling', '000001-010000.txt'))
    return _run(labels, wav_dp, out_dp, num_workers, cfg)


def parse_thchs30_labels(data_dp: str) -> Dict[str, Tuple[str, str]]:
    """THCHS-30 `.wav.trn` sidecar files -> {name: (pinyin, zero-prosody)}.

    The reference's thchs30 preprocessor is marked broken
    (``datasets/thchs30.py:10`` returns the wrong metadata tuple shape); this
    is the working equivalent producing the standard contract.  THCHS-30 has
    no prosody labels, so every syllable gets mark 0 (word-internal).
    """
    r = {}
    for fn in sorted(os.listdir(data_dp)):
        if not fn.endswith('.wav'):
            continue
        trn = os.path.join(data_dp, fn + '.trn')
        if not os.path.exists(trn):
            continue
        with open(trn, encoding='utf-8') as fh:
            fh.readline()                     # kanji line
            pinyin = fh.readline().strip().lower()
        if not pinyin:
            continue
        name = os.path.splitext(fn)[0]
        r[name] = (pinyin, '0' * len(pinyin.split(' ')))
    return r


def preprocess_thchs30(base_dir: str, out_dir: str, num_workers: int = 4,
                       cfg: Optional[Config] = None) -> Dict:
    cfg = cfg or Config()
    in_dir = os.path.join(base_dir, 'thchs30')
    if not os.path.exists(in_dir):
        in_dir = os.path.join(base_dir, 'data_thchs30')
    wav_dp = os.path.join(in_dir, 'data')
    out_dp = os.path.join(base_dir, out_dir)
    os.makedirs(out_dp, exist_ok=True)
    labels = parse_thchs30_labels(wav_dp)
    return _run(labels, wav_dp, out_dp, num_workers, cfg)


def preprocess_generic(base_dir: str, out_dir: str, metadata_csv: str,
                       wav_dir: str = 'wavs', num_workers: int = 4,
                       cfg: Optional[Config] = None) -> Dict:
    """Skeleton preprocessor: ``name|pinyin|prds`` rows + a wav folder
    (capability equivalent of ``datasets/__skel__.py``)."""
    cfg = cfg or Config()
    wav_dp = os.path.join(base_dir, wav_dir)
    out_dp = os.path.join(base_dir, out_dir)
    os.makedirs(out_dp, exist_ok=True)
    labels = {}
    with open(metadata_csv, encoding='utf-8') as fh:
        for line in fh:
            parts = line.strip().split('|')
            if len(parts) == 3:
                labels[parts[0]] = (parts[1], parts[2])
            elif len(parts) == 2:
                pinyin = parts[1]
                labels[parts[0]] = (pinyin, '0' * len(pinyin.split(' ')))
    return _run(labels, wav_dp, out_dp, num_workers, cfg)


def _run(labels: Dict[str, Tuple[str, str]], wav_dp: str, out_dp: str,
         num_workers: int, cfg: Config) -> Dict:
    worker = partial(_worker, out_dp=out_dp, wav_dp=wav_dp, cfg=cfg.audio)
    items = sorted(labels.items())
    if num_workers > 1:
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=get_context('spawn')) as ex:
            metadata = list(ex.map(worker, items, chunksize=16))
    else:
        metadata = [worker(it) for it in items]
    metadata = [mt for mt in metadata if mt is not None]
    if not metadata:
        raise ValueError(
            'no utterances survived preprocessing -- check wav paths and that '
            'metadata rows are name|pinyin|prds with per-syllable prosody marks')
    if DROPOUT_2SIGMA and len(metadata) > 8:
        metadata = filter_2sigma(metadata)
    stats = aggregate_stats(metadata, cfg.audio)
    write_metadata(metadata, stats, wav_dp, out_dp)
    cfg.save(out_dp)                       # freeze config next to the features
    return stats


def _worker(item, out_dp: str, wav_dp: str, cfg: AudioConfig):
    name, feats = item
    return make_metadata(name, feats, os.path.join(wav_dp, f'{name}.wav'),
                         out_dp, cfg)


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--base_dir', required=True)
    p.add_argument('--dataset', default='databaker',
                   choices=['databaker', 'thchs30', 'generic'])
    p.add_argument('--out_dir', default='processed')
    p.add_argument('--metadata_csv', default=None,
                   help='for --dataset generic: name|pinyin|prds rows')
    p.add_argument('--wav_dir', default='wavs')
    p.add_argument('--num_workers', type=int, default=4)
    args = p.parse_args()
    if args.dataset == 'databaker':
        stats = preprocess_databaker(args.base_dir, args.out_dir, args.num_workers)
    elif args.dataset == 'thchs30':
        stats = preprocess_thchs30(args.base_dir, args.out_dir, args.num_workers)
    else:
        stats = preprocess_generic(args.base_dir, args.out_dir,
                                   args.metadata_csv, args.wav_dir,
                                   args.num_workers)
    for k, v in stats.items():
        print(f'{k}: {v}')


if __name__ == '__main__':
    main()
