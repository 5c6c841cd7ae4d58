"""Symbol tables for the two G2P modes (reference ``transtacos/text/symbols.py``).

Markers: ``_pad='_'`` (MUST be id 0), ``_eos='~'``, ``_sep='/'``, ``_unk='?'``.
Vocabulary = markers + sorted(phone set - markers); the vacant phonology slot
``'_'`` aliases the pad marker, exactly like the reference.
"""

from __future__ import annotations

from typing import Dict, List

from .phonology import phonodict

PAD = '_'
EOS = '~'
SEP = '/'
UNK = '?'
MARKERS = [PAD, EOS, SEP, UNK]   # PAD must stay at index 0

# G2P = 'seq': raw character mode (reference symbols.py:12)
_CHARS = 'abcdefghijklmnopqrstuvwxyz 12345'

# G2P = 'syl4': consonant + vowel + ending phone set (reference symbols.py:28-31)
_SYL4 = phonodict.consonants + phonodict.vowels + phonodict.endings

_G2P_MAPPING: Dict[str, List[str]] = {
    'seq': list(_CHARS),
    'syl4': _SYL4,
}


class SymbolTable:
    def __init__(self, g2p: str = 'syl4'):
        units = _G2P_MAPPING[g2p]
        assert len(set(units)) == len(units), 'duplicate phonetic units'
        self.symbols = MARKERS + sorted(set(units) - set(MARKERS))
        self._to_id = {s: i for i, s in enumerate(self.symbols)}
        self._to_sym = {i: s for i, s in enumerate(self.symbols)}

    def symbol_to_id(self, sym: str) -> int:
        return self._to_id.get(sym, self._to_id[UNK])

    def id_to_symbol(self, idx: int) -> str:
        return self._to_sym.get(idx, UNK)

    def __len__(self) -> int:
        return len(self.symbols)

    @property
    def pad_id(self) -> int:
        return self._to_id[PAD]

    @property
    def eos_id(self) -> int:
        return self._to_id[EOS]

    @property
    def sep_id(self) -> int:
        return self._to_id[SEP]

    @property
    def unk_id(self) -> int:
        return self._to_id[UNK]

    def encode(self, phonemes: List[str]) -> List[int]:
        return [self.symbol_to_id(p) for p in phonemes]

    def decode(self, ids) -> List[str]:
        return [self.id_to_symbol(int(i)) for i in ids]


_tables: Dict[str, SymbolTable] = {}


def get_table(g2p: str = 'syl4') -> SymbolTable:
    if g2p not in _tables:
        _tables[g2p] = SymbolTable(g2p)
    return _tables[g2p]


def get_vocab_size(g2p: str = 'syl4') -> int:
    return len(get_table(g2p))
