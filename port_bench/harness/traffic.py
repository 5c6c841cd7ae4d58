"""The one traffic generator: a cell's traffic file holds only numbers and
syllables, and this module turns them and ``--seed`` into texts and a
schedule.

* The pool: one text per entry of ``pool.syllables``, each of that many
  syllables drawn from ``inventory`` (a frozen copy of
  ``transtacos_retunegan_tpu_torch/tools/synth_corpus.py::sample_texts``,
  lines 237-242, with the length given instead of drawn; verdict: sound).
  The inventory holds syllables of one serialized width, so every seed's
  pool has the same text lengths and the same work.
* Each text's decode stops after ceil(syllables * frames_per_syllable / r)
  steps (the stop head is fitted to that).
* The order: blocks of ``pool.counts`` (how often each text comes in a
  block, which sets the mean length), each block shuffled by the seed.  So
  every seed sends the same multiset of texts, in another order.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), salt])


def pool_texts(traffic: Dict, seed: int) -> List[str]:
    """One numbered-pinyin text per pool entry."""
    inv = traffic['inventory']
    r = rng(seed, 1)
    return [' '.join(inv[int(j)] for j in r.integers(0, len(inv), n))
            for n in traffic['pool']['syllables']]


def target_steps(traffic: Dict, r: int) -> List[int]:
    fps = traffic['frames_per_syllable']
    return [math.ceil(n * fps / r) for n in traffic['pool']['syllables']]


def order(traffic: Dict, seed: int, n: int) -> List[int]:
    """The first ``n`` pool indices of the request sequence."""
    block = [i for i, c in enumerate(traffic['pool']['counts']) for _ in range(c)]
    r = rng(seed, 2)
    out: List[int] = []
    while len(out) < n:
        out.extend(int(i) for i in r.permutation(block))
    return out[:n]


def block_mean_syllables(traffic: Dict) -> float:
    counts = traffic['pool']['counts']
    return sum(c * n for c, n in zip(counts, traffic['pool']['syllables'])) / sum(counts)
