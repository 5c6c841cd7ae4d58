"""The stop head, fitted at a small width on the CPU: the frozen reference
stops each pool text after exactly its target's steps."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.harness import serving, stophead, traffic
from port_bench.reference.config import Config
from port_bench.reference.serve import Reference

TINY = Path(__file__).resolve().parent / 'tiny.json'
WL = Path(__file__).resolve().parents[1] / 'workloads' / 'rgs-serve-c32.json'


@pytest.fixture(scope='module')
def fitted():
    torch.set_num_threads(2)
    wl = json.loads(WL.read_text())
    wl['pool'] = {'syllables': [2, 3, 5, 7], 'counts': [1, 1, 1, 1]}
    cfg = Config.load(str(TINY))
    acoustic, generator = serving.weights(cfg, 2 ** 31 + 3, 'cpu')
    texts = traffic.pool_texts(wl, 2 ** 31 + 3)
    targets = traffic.target_steps(wl, cfg.acoustic.outputs_per_step)
    ref = Reference(cfg, acoustic, generator, 'cpu', 3)
    ws = serving.fit_stop(ref, texts, targets)
    ref.set_stop(ws, -20.0)
    rows = serving.reference_logits(ref, texts, targets)
    bias = stophead.cohort_bias(list(zip(rows, targets)))
    ref.set_stop(ws, bias)
    return ref, texts, targets, rows, bias


def test_each_text_stops_at_its_target(fitted):
    ref, texts, targets, _, _ = fitted
    assert [ref.own_steps(t) for t in texts] == targets


def test_ramp_crosses_at_the_target(fitted):
    _, _, targets, rows, bias = fitted
    for z, t in zip(rows, targets):
        assert z[t - 1] + bias > 0.4
        assert np.max(z[:t - 1]) + bias < -0.4


def test_bias_needs_a_margin():
    z = np.array([-2.0, -1.0, 0.02, 1.0])
    with pytest.raises(RuntimeError):
        stophead.cohort_bias([(z, 3), (z, 4)], margin=0.05)
    assert stophead.cohort_bias([(z, 4)]) == pytest.approx(-(0.02 + 1.0) / 2)
