"""Corpus analysis: the numbers that seed config constants, ported from
``transtacos_retunegan_tpu/tools/corpus_stats.py`` (the same numpy code).

Capability rebuild of the reference's ``stats/`` scripts
(``DataBaker_gen_stat.py``, ``DataBaker_print_symbols.py``,
``DataBaker_print_pinyins.py``, ``thchs30_gen_vbanks.py``,
``inspect_preproc.py``): the symbol and pinyin inventories of a corpus,
the f0/c0 ranges that become the quantizer bounds
(``transtacos/hparam.py:22-25`` were produced this way), durations,
TextGrid phone/word duration statistics (a first-party Praat parser), and
the split of THCHS-30 corpora into per-voice-type banks
(``stats/thchs30_gen_vbanks.py:1-55``).

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.corpus_stats --data_dir processed/ \
      [--textgrid_dir PhoneLabeling/] [--gen_vbanks]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from ..text import g2p


def feature_ranges(data_dir: str) -> Dict[str, float]:
    """f0/c0 min-max over a preprocessed corpus -> quantizer bounds."""
    f0_min, f0_max = np.inf, -np.inf
    c0_min, c0_max = np.inf, -np.inf
    n = 0
    for fn in os.listdir(data_dir):
        if fn.startswith('f0-'):
            f0 = np.load(os.path.join(data_dir, fn))
            f0_min, f0_max = min(f0_min, float(f0.min())), max(f0_max, float(f0.max()))
            n += 1
        elif fn.startswith('c0-'):
            c0 = np.load(os.path.join(data_dir, fn))
            c0_min, c0_max = min(c0_min, float(c0.min())), max(c0_max, float(c0.max()))
    return {'f0min': f0_min, 'f0max': f0_max, 'c0min': c0_min, 'c0max': c0_max,
            'n_utterances': n}


def symbol_inventory(data_dir: str) -> Dict[str, Counter]:
    """Collect pinyin syllables and syl4 phones used by a corpus."""
    pinyins: Counter = Counter()
    phones: Counter = Counter()
    with open(os.path.join(data_dir, 'train.txt'), encoding='utf-8') as fh:
        for line in fh:
            parts = line.strip().split('|')
            if len(parts) != 3:
                continue
            for syl in parts[2].split(' '):
                pinyins[syl] += 1
            c, v, t, vx = g2p.to_syl4(parts[2])
            for lane in (c, v, vx):
                for ph in lane:
                    if ph != '_':
                        phones[ph] += 1
    return {'pinyins': pinyins, 'phones': phones}


def duration_stats(data_dir: str, cfg: Config) -> Dict[str, float]:
    lens = []
    for fn in os.listdir(data_dir):
        if fn.startswith('mel-'):
            lens.append(np.load(os.path.join(data_dir, fn), mmap_mode='r').shape[1])
    lens = np.asarray(lens)
    if len(lens) == 0:
        return {}
    sec = lens * cfg.audio.hop_length / cfg.audio.sample_rate
    return {'n': int(len(lens)), 'total_hours': float(sec.sum() / 3600),
            'min_frames': int(lens.min()), 'max_frames': int(lens.max()),
            'avg_frames': float(lens.mean())}


# ---------------------------------------------------------------------------
# TextGrid phone/word duration statistics (reference DataBaker_gen_stat.py)
# ---------------------------------------------------------------------------

def read_textgrid(path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """Minimal first-party Praat TextGrid reader (long and short text form).

    Returns {tier_name: [(xmin, xmax, text), ...]} for IntervalTiers.  Covers
    what DataBaker's ``PhoneLabeling/*.interval`` files use; no dependency on
    the ``tgt`` package the reference imports.
    """
    with open(path, encoding='utf-8', errors='replace') as fh:
        content = fh.read()
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    if '"IntervalTier"' not in content:
        return tiers
    num = r'(-?\d+\.?\d*(?:[eE][+-]?\d+)?)'
    qstr = r'"((?:[^"]|"")*)"'
    # split into tier chunks on the IntervalTier class marker
    for chunk in content.split('"IntervalTier"')[1:]:
        if re.search(r'xmin\s*=', chunk):
            # long form: keyed lines; the first xmin/xmax pair is the tier's
            # own extent, the rest belong to intervals in order
            m = re.search(r'name\s*=\s*' + qstr, chunk)
            if not m:
                continue
            name = m.group(1)
            xmins = [float(x) for x in
                     re.findall(r'xmin\s*=\s*' + num, chunk)]
            xmaxs = [float(x) for x in
                     re.findall(r'xmax\s*=\s*' + num, chunk)]
            texts = [t.replace('""', '"') for t in
                     re.findall(r'text\s*=\s*' + qstr, chunk)]
            tiers[name] = list(zip(xmins[1:], xmaxs[1:], texts))
        else:
            # short form: bare tokens -- "name" xmin xmax n then per
            # interval: xmin xmax "text"
            strings = re.findall(qstr, chunk)
            numbers = re.findall(num, chunk)
            if not strings or len(numbers) < 3:
                continue
            name = strings[0]
            n_int = int(float(numbers[2]))
            vals = [float(x) for x in numbers[3:3 + 2 * n_int]]
            texts = strings[1:1 + n_int]
            tiers[name] = [
                (vals[2 * i], vals[2 * i + 1], texts[i].replace('""', '"'))
                for i in range(min(n_int, len(vals) // 2, len(texts)))]
    return tiers


def textgrid_duration_stats(tg_dir: str, tier: str) -> Dict[str, Dict[str, float]]:
    """Per-label duration stats over a TextGrid directory
    (freq/mean/std/min/max seconds -- the reference's CSV columns)."""
    durs: Dict[str, list] = defaultdict(list)
    for fn in sorted(os.listdir(tg_dir)):
        if not fn.lower().endswith(('.textgrid', '.interval')):
            continue
        tiers = read_textgrid(os.path.join(tg_dir, fn))
        for xmin, xmax, text in tiers.get(tier, []):
            durs[text].append(xmax - xmin)
    return {k: {'freq': len(v), 'mean': float(np.mean(v)),
                'std': float(np.std(v)), 'min': float(np.min(v)),
                'max': float(np.max(v))}
            for k, v in durs.items()}


def write_duration_csv(stats: Dict[str, Dict[str, float]], path: str) -> None:
    cols = ('freq', 'mean', 'std', 'min', 'max')
    with open(path, 'w', encoding='utf-8') as fh:
        fh.write(',' + ','.join(cols) + '\n')
        for label, row in sorted(stats.items()):
            fh.write(label + ',' + ','.join(str(row[c]) for c in cols) + '\n')


# ---------------------------------------------------------------------------
# THCHS-30 per-voice-type banks (reference thchs30_gen_vbanks.py)
# ---------------------------------------------------------------------------

# speaker groupings are corpus facts (the reference's curated lists)
VBANK_SPEAKERS = {
    'male': ['A8', 'B8', 'C8', 'D8'],
    'female_power': ['A2', 'A4', 'A6', 'A14', 'A22', 'A34', 'B4', 'B6',
                     'B12', 'B22', 'B31', 'C4', 'C6', 'C31', 'D6', 'D31',
                     'D32'],
    'female_soft': ['A7', 'A11', 'A19', 'B7', 'C7', 'C14', 'C17', 'C18',
                    'C20', 'C32', 'D7', 'D11'],
    'child': ['A13', 'B11', 'C12', 'C13', 'C19', 'C21', 'C22', 'D21'],
}
_SPEAKER_RE = re.compile(r'([ABCD]\d+)_')


def gen_vbanks(data_dir: str, out_dir: str = None,
               index_file: str = 'train.txt') -> Dict[str, int]:
    """Split a preprocessed THCHS-30 index into per-voice-type vbank files.

    Utterance names carry the speaker id (``A2_17`` etc.); rows group by
    speaker and concatenate per voice type into ``vbank_<type>.txt`` next to
    the index (same contract as the reference's four train.txt subsets).
    """
    out_dir = out_dir or data_dir
    by_speaker = defaultdict(list)
    with open(os.path.join(data_dir, index_file), encoding='utf-8') as fh:
        for line in fh:
            line = line.rstrip('\n')
            if not line:
                continue
            m = _SPEAKER_RE.search(line.split('|', 1)[0])
            if m:
                by_speaker[m.group(1)].append(line)
    counts = {}
    for vt, speakers in VBANK_SPEAKERS.items():
        rows = [r for uid in speakers for r in by_speaker.get(uid, [])]
        with open(os.path.join(out_dir, f'vbank_{vt}.txt'), 'w',
                  encoding='utf-8') as fh:
            fh.write('\n'.join(rows) + ('\n' if rows else ''))
        counts[vt] = len(rows)
    return counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', required=True)
    p.add_argument('--textgrid_dir', default=None,
                   help='PhoneLabeling dir: write words/phones duration CSVs')
    p.add_argument('--gen_vbanks', action='store_true', default=False,
                   help='split a THCHS-30 index into per-voice-type banks')
    args = p.parse_args(argv)
    cfg = Config()
    out = {
        'feature_ranges': feature_ranges(args.data_dir),
        'durations': duration_stats(args.data_dir, cfg),
    }
    inv = symbol_inventory(args.data_dir)
    out['n_distinct_pinyins'] = len(inv['pinyins'])
    out['n_distinct_phones'] = len(inv['phones'])
    out['top_pinyins'] = inv['pinyins'].most_common(20)
    if args.textgrid_dir:
        for tier in ('words', 'phones'):
            stats = textgrid_duration_stats(args.textgrid_dir, tier)
            path = os.path.join(args.data_dir, f'stat-{tier}.csv')
            write_duration_csv(stats, path)
            out[f'textgrid_{tier}'] = {'n_labels': len(stats), 'csv': path}
    if args.gen_vbanks:
        out['vbanks'] = gen_vbanks(args.data_dir)
    print(json.dumps(out, indent=2, default=str))


if __name__ == '__main__':
    main()
