"""Text frontend: syl4 serialization, text normalization, clause packing.

Serialization turns the 4-lane syl4 representation into the flat
``[T, 2]`` (phone-id, tone) sequence the acoustic model consumes:

* training path  (reference ``transtacos/data.py:119-147``): per syllable emit
  non-vacant C, V, Vx each carrying the syllable tone, then a '/' separator
  with tone 0; prosody marks attach to separator positions, are
  backward-filled, and get 5 at EOS.
* inference path (reference ``transtacos/synth.py:48-70``): same but without
  prosody (the model's prdsnet predicts them).

Text normalization mirrors the serving layer (``app.py:45-58``,
``transtacos/server.py:66-79``): strip ignorable punctuation, break on
sentence punctuation, pack clauses up to 20 chars.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from .g2p import text_to_phoneme
from .phonology import phonodict
from .symbols import EOS, SEP, get_table

REGEX_PUNCT_IGNORE = re.compile('、|：|；|“|”|‘|’')
REGEX_PUNCT_BREAK = re.compile('，|。|！|？')
MAX_CLAUSE_LENGTH = 20


def serialize_train(pinyin: str, prds: List[int], g2p: str = 'syl4'
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(pinyin, per-syllable prosody) -> (seq [T,2] int32, prds [T] int32)."""
    table = get_table(g2p)
    if g2p == 'seq':
        phs = text_to_phoneme(pinyin + EOS, g2p)
        seq = np.asarray(table.encode(phs), np.int32)
        return np.stack([seq, np.zeros_like(seq)], -1), np.asarray(prds, np.int32)

    c_l, v_l, t_l, vx_l = text_to_phoneme(pinyin, g2p)
    assert len(c_l) == len(prds), f'{len(c_l)} syllables vs {len(prds)} prosody marks'

    cvvx, tx, p = [], [], []
    for i in range(len(c_l)):
        for unit in (c_l[i], v_l[i], vx_l[i]):
            if unit != phonodict.vacant:
                cvvx.append(unit)
                tx.append(t_l[i])
                p.append(0)
        cvvx.append(SEP)
        tx.append(0)
        p.append(int(prds[i]))

    ids = table.encode(cvvx + [EOS])
    tones = [int(t) if str(t).isdigit() else 0 for t in tx] + [0]
    # backward-fill prosody zeros, then 5 at EOS (reference data.py:134-137)
    for i in range(len(p) - 2, -1, -1):
        if p[i] == 0:
            p[i] = p[i + 1]
    p = p + [5]

    assert len(ids) == len(tones) == len(p)
    seq = np.stack([np.asarray(ids, np.int32), np.asarray(tones, np.int32)], -1)
    return seq, np.asarray(p, np.int32)


def serialize_inference(pinyin: str, g2p: str = 'syl4') -> np.ndarray:
    """pinyin -> seq [T,2] int32, no prosody input (reference synth.py:48-72)."""
    table = get_table(g2p)
    if g2p == 'seq':
        phs = text_to_phoneme(pinyin + EOS, g2p)
        ids = np.asarray(table.encode(phs), np.int32)
        return np.stack([ids, np.zeros_like(ids)], -1)

    c_l, v_l, t_l, vx_l = text_to_phoneme(pinyin, g2p)
    cvvx, tx = [], []
    for i in range(len(c_l)):
        for unit in (c_l[i], v_l[i], vx_l[i]):
            if unit != phonodict.vacant:
                cvvx.append(unit)
                tx.append(t_l[i])
        cvvx.append(SEP)
        tx.append(0)

    ids = table.encode(cvvx + [EOS])
    tones = [int(t) if str(t).isdigit() else 0 for t in tx] + [0]
    assert len(ids) == len(tones)
    return np.stack([np.asarray(ids, np.int32), np.asarray(tones, np.int32)], -1)


def deserialize(seq: np.ndarray, g2p: str = 'syl4') -> List[str]:
    """Decode a [T,2] sequence back to phone strings (for eval logging)."""
    table = get_table(g2p)
    return table.decode(seq[:, 0] if seq.ndim == 2 else seq)


def normalize_text(txt: str, max_clause: int = MAX_CLAUSE_LENGTH) -> List[str]:
    """Punctuation strip/split + clause packing (reference ``app.py:45-58``).

    NOTE the reference WebUI discards the ignore-sub result (``app.py:50``
    re-subs on the raw text) -- that is a bug; the acoustic server's version
    (``transtacos/server.py:70-71``) applies both, which we reproduce.
    """
    txt = REGEX_PUNCT_IGNORE.sub('', txt)
    txt = REGEX_PUNCT_BREAK.sub(' ', txt)
    segs = ['']
    for rs in (s.strip() for s in txt.split(' ')):
        if not rs:
            continue
        if (not segs[-1]) or (len(rs) + len(segs[-1]) < max_clause):
            segs[-1] = segs[-1] + rs
        else:
            segs.append(rs)
    return [s for s in segs if s]


class KanjiPinyin:
    """Pluggable kanji -> numbered-pinyin provider.

    The reference shells out to the third-party ``xpinyin`` package
    (``app.py:40,65``); that package is not in this image, so this wrapper
    uses it if importable, else a user-supplied TSV (``U+XXXX<TAB>pin1``
    or ``好<TAB>hao3`` rows), else raises.  All serving paths also accept
    numbered pinyin directly, which needs no provider.
    """

    def __init__(self, table_path: Optional[str] = None):
        self._impl = None
        self._table = None
        try:
            from xpinyin import Pinyin  # type: ignore
            self._impl = Pinyin()
        except ImportError:
            if table_path:
                self._table = {}
                with open(table_path, encoding='utf-8') as fh:
                    for line in fh:
                        parts = line.rstrip('\n').split('\t')
                        if len(parts) < 2:
                            continue
                        key = parts[0]
                        if key.lower().startswith('u+'):
                            key = chr(int(key[2:], 16))
                        self._table[key] = parts[1].strip().lower()

    @property
    def available(self) -> bool:
        return self._impl is not None or self._table is not None

    def __call__(self, hanzi: str) -> str:
        if self._impl is not None:
            return ' '.join(self._impl.get_pinyin(hanzi, tone_marks='numbers').split('-'))
        if self._table is not None:
            return ' '.join(self._table.get(ch, ch) for ch in hanzi)
        raise RuntimeError(
            'no kanji->pinyin provider: install xpinyin or pass a table file; '
            'alternatively submit numbered pinyin directly')


_PINYIN_RE = re.compile(r'^([a-zü]+[0-5]?)( [a-zü]+[0-5]?)*$')


def looks_like_pinyin(txt: str) -> bool:
    return bool(_PINYIN_RE.match(txt.strip().lower()))
