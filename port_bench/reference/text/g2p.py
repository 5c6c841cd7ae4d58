"""syl4 G2P: numbered pinyin string <-> 4 parallel phone lists.

Reference: ``transtacos/text/g2p.py``.  ``to_syl4`` splits each syllable into
(consonant, vowel, tone, ending); digitless syllables get neutral tone '5';
an 'r' suffix (erhua) strips the written r and overrides the ending with
``_R`` (except the standalone syllable 'er' itself).
Unparseable syllables become UNK in all four slots.
"""

from __future__ import annotations

from typing import List

from .phonology import phonodict
from .symbols import UNK

Syl4 = List[List[str]]   # [C, V, T, Vx], each of length n_syllables


def to_syl4(pinyin: str, sep: str = ' ') -> Syl4:
    c_l, v_l, t_l, vx_l = [], [], [], []
    py_ls = pinyin.split(sep)
    for py in py_ls:
        t = py[-1] if py else ''
        if t.isdigit():
            py = py[:-1]
        else:
            t = '5'

        r_ending = False
        if py.endswith('r'):
            r_ending = True
            if py != 'er':
                py = py[:-1]

        cve = phonodict[py]
        if cve is None:
            c_l.append(UNK); v_l.append(UNK); t_l.append(UNK); vx_l.append(UNK)
            continue
        c, v, e = cve
        c_l.append(c)
        v_l.append(v)
        t_l.append(t)
        vx_l.append('_R' if r_ending else e)   # R overrides N / NG

    assert len(c_l) == len(v_l) == len(t_l) == len(vx_l) == len(py_ls)
    return [c_l, v_l, t_l, vx_l]


def from_syl4(syl4: Syl4, sep: str = ' ') -> str:
    return sep.join(''.join(s) for s in zip(*syl4))


def text_to_phoneme(text: str, g2p: str = 'syl4'):
    """Dispatch by g2p mode (reference ``transtacos/text/text.py:12-24``)."""
    if g2p == 'syl4':
        return to_syl4(text)
    if g2p == 'seq':
        return list(text.lower())
    raise ValueError(f'unknown g2p mode {g2p!r}')
