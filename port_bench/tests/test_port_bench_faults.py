"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: an answer altered where it is produced and
half of a cohort left out (serving); a step that leaves its state
unchanged and half of the batch left out, its mean over the rest
(training).  The cells hold one chip, so no exchange between chips can be
left out.  CPU, small widths, the cells' own limits; the search for a
card is skipped by driving the harness below ``run.py``."""

import copy
import json
from pathlib import Path

import pytest
import torch

from port_bench.harness import common, serving, training

BENCH = Path(__file__).resolve().parents[1]
TINY = str(Path(__file__).resolve().parent / 'tiny.json')


def record(cell: str, **traffic):
    wl = json.loads((BENCH / 'workloads' / f'{cell}.json').read_text())
    wl.update(traffic)
    return common.Record(cell={'name': cell, 'chips': 1}, workload=wl,
                         seed=2 ** 31 + 21, trace=False,
                         extra={'config_file': TINY, 'seconds': 2.5, 'device': 'cpu'})


def serve_with(fault) -> dict:
    rec = record('rgs-serve-c32', clients=6, window_ms=150,
                 pool={'syllables': [2, 3, 4], 'counts': [1, 1, 1]})
    served = serving.build(rec, 'cpu')
    fault(served.synth)
    _, answers = serving.serve(rec, served)
    return serving.check(served, rec, answers, 'cpu')


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_serving_run_is_correct():
    checks = serve_with(lambda synth: None)
    assert all(c['ok'] for c in checks.values()), checks


def test_answer_altered_where_produced():
    def fault(synth):
        gen = synth._generate
        synth._generate = lambda mel, tmpl: gen(mel, tmpl) * 1.25
    checks = serve_with(fault)
    assert not all(c['ok'] for c in checks.values())
    assert not checks['wav_err_ratio']['ok']


def test_half_a_cohort_left_out():
    def fault(synth):
        run = synth.synthesize_spec_batch

        def half(pinyins, rows=1):
            keep = (len(pinyins) + 1) // 2
            specs = run(pinyins[:keep], rows=rows)
            return specs + [specs[-1]] * (len(pinyins) - keep)
        synth.synthesize_spec_batch = half
    checks = serve_with(fault)
    assert not all(c['ok'] for c in checks.values()), checks


def gan_with(step_fn=None) -> dict:
    rec = record('rgs-gan-b16', pool=3)
    trained = training.build(rec, 'cpu', step_fn=step_fn)
    return training.check(trained, rec, 'cpu')


def test_sound_training_run_is_correct():
    checks = gan_with()
    assert all(c['ok'] for c in checks.values()), checks


def test_step_leaves_state_unchanged():
    from transtacos_retunegan_tpu_torch.train.vocoder_step import gan_train_step

    def unchanged(cfg, state, batch, noise, steps_per_epoch=568):
        _, metrics = gan_train_step(cfg, copy.deepcopy(state), batch, noise,
                                    steps_per_epoch)
        return state, metrics
    checks = gan_with(unchanged)
    assert not checks['update_median_gap']['ok']
    assert checks['update_median_gap']['value'] == pytest.approx(1.0)


def test_half_the_batch_left_out():
    from port_bench.control import half_batch
    checks = gan_with(half_batch)
    assert not checks['loss_rel_gap']['ok'] and not checks['grad_norm_gap']['ok']
