"""Mandarin pinyin -> (consonant, vowel, ending) phonology.

Capability-equivalent rebuild of the reference's CSV phone dictionary
(``transtacos/text/phonodict_cn.py`` + ``phonodict_cn.csv``): each written
pinyin syllable decomposes into an X-SAMPA-flavored triple
``(C, V, ending)`` where ``ending in {_N, _NG, _R, vacant}`` and the vacant
slot symbol is ``'_'`` (the pad marker).

Instead of shipping a table of ~400 syllables, the decomposition is expressed
as the underlying phonological rules (initial inventory + final rewrite rules
with initial-class context) plus a compact validity map of which
initial x final cells exist in Mandarin.  This reproduces the reference's
``Phonodict4`` entries exactly (same phoneme inventory: 22 consonants
including the vacant initial, 23 vowels, 3 endings).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

VACANT = '_'
ENDINGS = ['_N', '_NG', '_R']

# full initials, longest-match order; y/w are spelling devices handled below
_INITIALS = ['zh', 'ch', 'sh', 'b', 'p', 'm', 'f', 'd', 't', 'n', 'l',
             'g', 'k', 'h', 'j', 'q', 'x', 'r', 'z', 'c', 's', 'y', 'w']

# written final -> (vowel, ending) in the default context
_FINAL_MAP: Dict[str, Tuple[str, str]] = {
    'a': ('a', VACANT), 'o': ('o', VACANT), 'e': ('e', VACANT),
    'i': ('i', VACANT), 'u': ('u', VACANT), 'v': ('v', VACANT),
    'ai': ('ai', VACANT), 'ei': ('Ei', VACANT), 'ao': ('ao', VACANT),
    'ou': ('ou', VACANT), 'uo': ('uo', VACANT),
    'an': ('a', '_N'), 'en': ('e', '_N'), 'in': ('i', '_N'), 'un': ('u', '_N'),
    'vn': ('v', '_N'),
    'ang': ('a', '_NG'), 'eng': ('e', '_NG'), 'ing': ('i', '_NG'),
    'ong': ('o', '_NG'), 'ueng': ('ue', '_NG'),
    'ia': ('ia', VACANT), 'ian': ('iE', '_N'), 'iang': ('ia', '_NG'),
    'iong': ('io', '_NG'), 'ie': ('iE', VACANT), 'iu': ('iou', VACANT),
    'iao': ('iao', VACANT), 'io': ('io', VACANT), 'iou': ('iou', VACANT),
    'ua': ('ua', VACANT), 'uan': ('ua', '_N'), 'uang': ('ua', '_NG'),
    'ue': ('vE', VACANT), 'ui': ('uEi', VACANT), 'uai': ('uai', VACANT),
    've': ('vE', VACANT), 'van': ('vE', '_N'),
}

# which finals each initial can take (Mandarin syllabary; '' = zero initial).
# This is the validity skeleton of the reference CSV, one line per initial.
_VALID: Dict[str, str] = {
    '':  'a o e ai ei ao ou an en ang eng er',
    'b': 'a o ai ei ao an en ang eng i ie iao ian in ing u',
    'p': 'a o ai ei ao ou an en ang eng i ie iao ian in ing u',
    'm': 'a o e ai ei ao ou an en ang eng i ie iao iu ian in ing u',
    'f': 'a o ei ou an en ang eng u iao',
    'd': 'a e ai ei ao ou an en ang eng ong i ia ie iao iu ian ing u uo ui uan un',
    't': 'a e ai ao ou an ang eng ong i ie iao ian ing u uo ui uan un',
    'n': 'a e ai ei ao ou an en ang eng ong i ie iao iu ian in iang ing u uo uan un v ve',
    'l': 'a e ai ei ao ou an ang eng ong i ia ie iao iu ian in iang ing u uo uan un v ve',
    'g': 'a e ai ei ao ou an en ang eng ong u ua uo uai ui uan un uang',
    'k': 'a e ai ao ou an en ang eng ong u ua uo uai ui uan un uang',
    'h': 'a e ai ei ao ou an en ang eng ong u ua uo uai ui uan un uang',
    'j': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'q': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'x': 'i ia ie iao iu ian in iang ing iong u ue uan un',
    'zh': 'a e i ai ei ao ou an en ang eng ong u ua uo uai ui uan un uang',
    'ch': 'a e i ai ao ou an en ang eng ong u ua uo uai ui uan un uang',
    'sh': 'a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang',
    'r': 'e i ao ou an en ang eng ong u ua uo ui uan un',
    'z': 'a e i ai ei ao ou an en ang eng ong u uo ui uan un',
    'c': 'a e i ai ao ou an en ang eng ong u uo ui uan un',
    's': 'a e i ai ao ou an en ang eng ong u uo ui uan un',
    'y': 'a o e i u ue uan un in ing ang an ao ou ong',
    'w': 'a o ai ei an en ang eng u',
}


def _resolve(initial: str, final: str) -> Optional[Tuple[str, str, str]]:
    """(initial, written final) -> (C, V, ending) with context rules applied."""
    if final == 'er':
        # rhotic standalone syllable: vacant C, 'e', _R ending
        return (VACANT, 'e', '_R') if initial == '' else None

    if initial == 'y':
        # y is a spelling device: yi->i, yin/ying, ya->ia, yu-group -> v
        c = VACANT
        if final in ('u', 'ue', 'uan', 'un'):
            final = {'u': 'v', 'ue': 've', 'uan': 'van', 'un': 'vn'}[final]
        elif final in ('i', 'in', 'ing'):
            pass
        elif final in ('a', 'o', 'e', 'ao', 'ou', 'an', 'ang', 'ong'):
            final = {'a': 'ia', 'o': 'io', 'e': 'ie', 'ao': 'iao', 'ou': 'iou',
                     'an': 'ian', 'ang': 'iang', 'ong': 'iong'}[final]
        else:
            return None
    elif initial == 'w':
        # w is a spelling device: wu->u, wa->ua, wen->un, weng->ueng, ...
        c = VACANT
        if final == 'u':
            pass
        elif final in ('a', 'o', 'ai', 'ei', 'an', 'en', 'ang', 'eng'):
            final = {'a': 'ua', 'o': 'uo', 'ai': 'uai', 'ei': 'ui', 'an': 'uan',
                     'en': 'un', 'ang': 'uang', 'eng': 'ueng'}[final]
        else:
            return None
    else:
        c = initial if initial else VACANT
        # context rewrites
        if final == 'i' and initial in ('z', 'c', 's'):
            v, e = 'i0', VACANT
            return (c, v, e)
        if final == 'i' and initial in ('zh', 'ch', 'sh', 'r'):
            return (c, 'iR', VACANT)
        if initial in ('j', 'q', 'x'):
            # u-group is phonemically v after palatals
            final = {'u': 'v', 'un': 'vn', 'uan': 'van', 'ue': 've'}.get(final, final)
        if final == 'o' and initial in ('b', 'p', 'm', 'f'):
            final = 'uo'
        if final == 'ei' and initial != '':
            pass  # same mapping (Ei)

    if final not in _FINAL_MAP:
        return None
    v, e = _FINAL_MAP[final]
    return (c, v, e)


def _build_entries() -> Dict[str, Tuple[str, str, str]]:
    entries = {}
    for initial, finals in _VALID.items():
        for final in finals.split():
            cve = _resolve(initial, final)
            if cve is None:
                continue
            entries[initial + final] = cve
    return entries


class Phonodict4:
    """Drop-in equivalent of the reference ``Phonodict4``
    (``transtacos/text/phonodict_cn.py:12-79``)."""

    def __init__(self, vac_sym: str = VACANT):
        self.vacant = vac_sym
        self.entry = _build_entries()
        if vac_sym != VACANT:
            self.entry = {k: tuple(vac_sym if p == VACANT else p for p in v)
                          for k, v in self.entry.items()}
        cs, vs = set(), set()
        for c, v, _ in self.entry.values():
            cs.add(c)
            vs.add(v)
        self.consonants: List[str] = sorted(cs)
        self.vowels: List[str] = sorted(vs)
        self.endings: List[str] = list(ENDINGS)

    def __getitem__(self, py: str):
        return self.entry.get(py, None)

    def __contains__(self, py: str) -> bool:
        return py in self.entry

    def __len__(self) -> int:
        return len(self.entry)

    @property
    def vacant_symbol(self) -> str:
        return self.vacant

    def inspect(self) -> str:
        return (f'syllable count: {len(self.entry)}\n'
                f'consonants({len(self.consonants)}): {self.consonants}\n'
                f'vowels({len(self.vowels)}): {self.vowels}\n'
                f'endings({len(self.endings)}): {self.endings}')


phonodict = Phonodict4()
