"""The controls come out not correct: the reference computed one precision
below the configuration's, put in the program's place, on the card at the
cells' own sizes, one seed each (``port_bench/control.py`` reads a dozen).
Serving: float8 weights and inputs against the float32 reference (its
bf16 serving precision's next step down).  Training: TF32 against float32
with TF32 off.  Marked ``gpu``; skips without a card:
``python -m pytest -m gpu port_bench/tests/test_port_bench_control.py``."""

import json
from pathlib import Path

import pytest

from port_bench.harness import common

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def cell_record(cell: str, seed: int):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the controls are read on the card')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    entry = next(w for w in bench['workloads'] if w['name'] == cell)
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    wl = json.loads((BENCH / 'workloads' / f'{cell}.json').read_text())
    return common.Record(cell=entry, workload=wl, seed=seed, trace=False,
                         extra={'config_file': str(ROOT / conf['file']), 'seconds': 2.0})


def over_a_limit(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


SERVE = sorted(w['name'] for w in json.loads((ROOT / 'BENCHMARK.json').read_text())['workloads']
               if json.loads((BENCH / 'workloads' / f'{w["traffic"]}.json').read_text())
               ['driver'].startswith('serve'))


@pytest.mark.gpu
@pytest.mark.parametrize('cell', SERVE)
def test_serving_control_fails(cell):
    from port_bench.control import control_reading
    from port_bench.harness import serving
    rec = cell_record(cell, 2 ** 31 + 901)
    served = serving.build(rec, 'cuda')
    assert over_a_limit(control_reading(served), rec.workload['limits'])


@pytest.mark.gpu
def test_training_control_fails():
    import dataclasses
    from port_bench.harness import training
    rec = cell_record('rgs-gan-b16', 2 ** 31 + 902)
    t = training.build(rec, 'cuda')
    ref = training.reference_steps(t, 'cuda')
    tf32 = training.reference_steps(t, 'cuda', tf32=True)
    got = training.compare(dataclasses.replace(t, losses=tf32[0], first_grads=tf32[1],
                                               after=tf32[2]), *ref)
    assert over_a_limit(got, rec.workload['limits'])
