"""The traffic generator: the same schedule from the same seed, the same
sizes from every seed."""

import json
from collections import Counter
from pathlib import Path

import pytest

from port_bench.harness import traffic
from port_bench.reference.text import frontend

WORKLOADS = Path(__file__).resolve().parents[1] / 'workloads'
SERVE = sorted(p for p in WORKLOADS.glob('*.json')
               if json.loads(p.read_text())['driver'].startswith('serve'))
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


def load(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize('path', SERVE, ids=lambda p: p.stem)
def test_same_seed_same_schedule(path):
    wl = load(path)
    assert traffic.pool_texts(wl, 12345) == traffic.pool_texts(wl, 12345)
    assert traffic.order(wl, 12345, 500) == traffic.order(wl, 12345, 500)
    assert traffic.pool_texts(wl, 12345) != traffic.pool_texts(wl, 12346)


@pytest.mark.parametrize('path', SERVE, ids=lambda p: p.stem)
def test_every_seed_same_sizes(path):
    """Each pool text has its entry's syllables and the same serialized
    length whatever the seed; every block of the order holds the same
    multiset."""
    wl = load(path)
    block = sum(wl['pool']['counts'])
    lengths = None
    for seed in SEEDS:
        texts = traffic.pool_texts(wl, seed)
        assert [len(t.split()) for t in texts] == wl['pool']['syllables']
        n = [frontend.serialize_inference(t, 'syl4').shape[0] for t in texts]
        assert lengths in (None, n)
        lengths = n
        seq = traffic.order(wl, seed, 4 * block)
        for k in range(4):
            assert Counter(seq[k * block:(k + 1) * block]) == Counter(
                dict(enumerate(wl['pool']['counts'])))


@pytest.mark.parametrize('path', SERVE, ids=lambda p: p.stem)
def test_mean_length_and_stop_budget(path):
    """The mix's mean is DataBaker's (about 16 syllables) and the pool's
    steps stay under r * n_mel = 400, where the stop head fits exactly."""
    wl = load(path)
    assert traffic.block_mean_syllables(wl) == pytest.approx(16.1, abs=0.3)
    assert sum(traffic.target_steps(wl, 5)) < 400
