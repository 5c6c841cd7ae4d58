"""BENCHMARK.json against the files the harness finds by name, and a run
without a card: it exits non-zero and prints no result."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_every_metric_has_a_reader():
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert NAME.match(m['name']), m['name']
        assert (BENCH / 'metrics' / f'{m["name"]}.py').is_file(), m['name']


def test_every_cell_has_its_files():
    configs = {c['name']: c for c in SPEC['configs']}
    for w in SPEC['workloads']:
        assert NAME.match(w['name']) and w['chips'] == 1
        assert (ROOT / configs[w['config']]['file']).is_file()
        traffic = json.loads((BENCH / 'workloads' / f'{w["traffic"]}.json').read_text())
        assert (BENCH / 'drivers' / f'{traffic["driver"]}.py').is_file()
        assert set(traffic['limits']) and all(v >= 0 for v in traffic['limits'].values())


def test_per_layer_metrics_move_what_their_cells_report():
    reports = {}
    for m in SPEC['end_to_end']:
        for w in m.get('workloads', [c['name'] for c in SPEC['workloads']]):
            reports.setdefault(w, set()).add(m['name'])
    layers = {m['layer'] for m in SPEC['per_layer']}
    for m in SPEC['per_layer']:
        for w in m['workloads']:
            assert m['moves'] in reports[w], (m['name'], w)
    for w in SPEC['workloads']:
        assert 'setup_s' in reports[w['name']] and len(reports[w['name']]) >= 2
        assert any(w['name'] in m['workloads'] for m in SPEC['per_layer'])
    assert layers


def test_configurations_match_the_port():
    """Each configuration file loads as the port's Config, unreduced."""
    from transtacos_retunegan_tpu_torch.config import Config
    for c in SPEC['configs']:
        cfg = Config.load(str(ROOT / c['file']))
        assert c['reduced'] == [] and cfg.acoustic == Config().acoustic


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, str(BENCH / 'run.py'), '--workload',
                          SPEC['workloads'][0]['name'], '--seed', str(2 ** 31 + 5),
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''
