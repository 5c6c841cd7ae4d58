"""The port's study tools on trained runs, against the JAX package's tools
on the same runs: one JAX acoustic run and one JAX generator run at the
small configuration of ``tests/test_torch_port_run_dirs.py``, written
with the JAX package's checkpoint code and carried to the port by its
converter (``export_jax_run.py``, then ``tools/import_jax_run.py``), and
one data dir (random features, 3 held-out texts, their wavs).

* ``eval_teacher_forced``: every loss within 1e-5 relative (the acoustic
  train step's tolerance), the dropout and noise off on both sides as
  ``torch_port_common.acoustic_interceptor`` turns them off in JAX.
* ``eval_synthesis_alignment``, ``coverage_diagnosis``: the alignments and
  their metrics within 1e-4 of the JAX ``Synthesizer(acoustic_dir=)``'s
  (``test_torch_port_run_dirs.py``'s tolerance for served runs; the stop
  bias is -20, so that both decode all 8 steps; the port's decoder weights
  in float32, as the JAX CPU decode's); the same per-token kinds.
* ``draw_embd_sim``: the similarity matrices within 1e-6 of the JAX tool's
  ``cosine_sim`` on the JAX tables.
* ``bf16_ab``: the float32 metrics within 1e-4 of the JAX tool's, with the
  Griffin-Lim phase of each item drawn from one key on both sides.

The JAX ``Synthesizer`` is built once (its constructor costs most of this
file's time) and handed to each JAX tool in place of the one it builds.
"""

import functools
import json
import os
import sys
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
import test_torch_port_run_dirs as RD
from torch_port_common import (acoustic_interceptor, acoustic_tree, vocoder_batch,
                               vocoder_trees, write_npy_corpus)
from transtacos_retunegan_tpu.audio import features as jfeatures
from transtacos_retunegan_tpu.eval import metrics as jmetrics
from transtacos_retunegan_tpu.serve import pipeline as jpipeline
from transtacos_retunegan_tpu.tools import bf16_ab as jbf16
from transtacos_retunegan_tpu.tools import convergence_session as jcs
from transtacos_retunegan_tpu.tools import coverage_diagnosis as jcov
from transtacos_retunegan_tpu.tools import decay_session as jdecay
from transtacos_retunegan_tpu.tools import draw_embd_sim as jembd
from transtacos_retunegan_tpu.train import checkpoint as jck
from transtacos_retunegan_tpu_torch.data import preprocess
from transtacos_retunegan_tpu_torch.eval import metrics as pmetrics
from transtacos_retunegan_tpu_torch.models.layers import Draws
from transtacos_retunegan_tpu_torch.serve import pipeline as ppipeline
from transtacos_retunegan_tpu_torch.serve.pipeline import Synthesizer
from transtacos_retunegan_tpu_torch.tools import (bf16_ab, convergence_session,
                                                  coverage_diagnosis, decay_session,
                                                  draw_embd_sim)

pytestmark = pytest.mark.usefixtures('few_threads')

JCFG, PCFG = RD.JCFG, RD.PCFG
N_TEST = 3


def _data_dir(base):
    """``write_npy_corpus``'s 24 utterances with the 3 shortest texts as the
    test split, whose features the preprocessor computes from a wav of
    each (a tone of its own pitch, 0.3 s)."""
    d = base / 'data'
    d.mkdir()
    write_npy_corpus(d)
    rows = (d / 'train.txt').read_text(encoding='utf-8').splitlines()
    test = sorted(rows, key=lambda r: len(r.split('|')[2]))[:N_TEST]
    (d / 'test.txt').write_text('\n'.join(test) + '\n', encoding='utf-8')
    wavs = base / 'wavs'
    wavs.mkdir()
    rng = np.random.RandomState(5)
    au = PCFG.audio
    for row in test:
        name, prds, text = row.split('|')
        t = np.arange(int(0.3 * au.sample_rate)) / au.sample_rate
        y = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 240) * t) + 0.01 * rng.randn(len(t))
        jfeatures.save_wav(y.astype(np.float32), str(wavs / f'{name}.wav'), JCFG.audio)
        assert preprocess.make_metadata(name, (text, prds), str(wavs / f'{name}.wav'),
                                        str(d), au) is not None
    (d / 'wav_path.txt').write_text(str(wavs))
    return str(d)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX runs (acoustic at ``RD.ACOUSTIC_STEP`` with the stop bias at
    -20; a generator alone), their port conversions, the data dir and the
    JAX ``Synthesizer`` over both JAX runs."""
    base = tmp_path_factory.mktemp('study_runs')
    tree = acoustic_tree(JCFG)
    tree['decoder_cell']['stop_projection']['bias'][:] = -20.0
    jax_ac = str(base / 'jax_acoustic')
    jck.save_acoustic(jax_ac, RD._counted_state(tree, JCFG, RD.ACOUSTIC_STEP))
    JCFG.save(jax_ac)
    gtree, _ = vocoder_trees(JCFG, vocoder_batch(JCFG, seed=70), seed=80)
    jax_voc = str(base / 'jax_vocoder')
    jck.save_tree(os.path.join(jax_voc, 'g_00000002'), {'generator': gtree})
    JCFG.save(jax_voc)
    jsynth = jpipeline.Synthesizer(JCFG, acoustic_dir=jax_ac, vocoder_dir=jax_voc)
    return {'tree': tree, 'jax_ac': jax_ac, 'jax_voc': jax_voc, 'jsynth': jsynth,
            'port_ac': RD._convert(jax_ac, base, 'acoustic')[1],
            'port_voc': RD._convert(jax_voc, base, 'vocoder')[1],
            'data': _data_dir(base)}


@pytest.fixture
def jax_tools_share(runs, monkeypatch):
    """The JAX tools get the module's JAX ``Synthesizer`` whatever they ask
    for (the float32 one: the CPU's default), and the port's decodes with
    float32 weights, as that one's decoder does (the port folds them to
    bf16 by default, which the kernel tests hold at 1e-2)."""
    monkeypatch.setattr(jpipeline, 'Synthesizer', lambda *a, **k: runs['jsynth'])
    monkeypatch.setattr(ppipeline, 'fold_params',
                        functools.partial(ppipeline.fold_params, dtype=torch.float32))
    return runs['jsynth']


def test_eval_teacher_forced_matches_jax(runs, monkeypatch):
    """The held-out losses (reference and per-item masks) and the prosody
    accuracy on the whole test split; with its own seeded draws the port's
    evaluation is finite and the same at every call."""
    with fnn.intercept_methods(acoustic_interceptor):
        want = jcs.eval_teacher_forced(JCFG, runs['data'], runs['jax_ac'])
    seeded = convergence_session.eval_teacher_forced(PCFG, runs['data'], runs['port_ac'], 'cpu')
    monkeypatch.setattr(convergence_session, 'eval_draws', lambda device: Draws())
    got = convergence_session.eval_teacher_forced(PCFG, runs['data'], runs['port_ac'], 'cpu')
    assert got.keys() == want.keys() == seeded.keys()
    assert got['n_test_items'] == want['n_test_items'] == N_TEST
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        assert np.isfinite(seeded[k]), k
    monkeypatch.undo()
    assert convergence_session.eval_teacher_forced(
        PCFG, runs['data'], runs['port_ac'], 'cpu') == seeded


def _texts(data):
    return [t for _, t, _ in convergence_session.held_out_texts(data)]


def test_eval_synthesis_alignment_matches_jax(runs, jax_tools_share, tmp_path):
    """The alignments of the held-out texts and their metrics, per
    utterance and on average, and the worst-coverage figure."""
    psynth = Synthesizer(PCFG, acoustic_dir=runs['port_ac'], devices=['cpu'])
    for text in _texts(runs['data']):
        got, want = psynth.synthesize_with_alignment(text), \
            jax_tools_share.synthesize_with_alignment(text)
        assert got['n_frames'] == want['n_frames'] == 8 * PCFG.acoustic.outputs_per_step
        np.testing.assert_allclose(got['alignment'], want['alignment'], atol=1e-4)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    want = jdecay.eval_synthesis_alignment(JCFG, runs['data'], runs['jax_ac'],
                                           str(tmp_path / 'jax'), tag='8')
    got = decay_session.eval_synthesis_alignment(PCFG, runs['data'], runs['port_ac'],
                                                 str(tmp_path / 'port'), tag='8',
                                                 device='cpu')
    assert got.keys() == want.keys()
    for g, w in zip(got['per_utt'], want['per_utt']):
        assert g.keys() == w.keys() and g['name'] == w['name'] and g['n_frames'] == w['n_frames']
        for k in ('diagonality', 'focus', 'coverage', 'mass_coverage'):
            assert abs(g[k] - w[k]) <= 1e-4, k
    for k in want:
        if k != 'per_utt':
            assert abs(got[k] - want[k]) <= 1e-4, k
    assert os.path.exists(tmp_path / 'port' / 'align_worst_8.png')


def test_coverage_diagnosis_matches_jax(runs, jax_tools_share, tmp_path, monkeypatch, capsys):
    """Both tools' mains on the same held-out texts: the same missed tokens,
    positions, symbols and kinds; coverage and masses within 1e-4 (plus the
    tools' rounding to 4 and 3 decimals)."""
    monkeypatch.setattr(sys, 'argv', ['coverage_diagnosis', '--data_dir', runs['data'],
                                      '--acoustic_dir', runs['jax_ac'], '--config',
                                      runs['jax_ac'], '--out', str(tmp_path / 'jax.json')])
    jcov.main()
    got = coverage_diagnosis.main(['--data_dir', runs['data'], '--acoustic_dir', runs['port_ac'],
                                   '--config', runs['port_ac'],
                                   '--out', str(tmp_path / 'port.json'), '--device', 'cpu'])
    capsys.readouterr()
    want = json.loads((tmp_path / 'jax.json').read_text())
    assert json.loads((tmp_path / 'port.json').read_text()) == got
    assert len(got['per_utt']) == len(want['per_utt']) == N_TEST
    for g, w in zip(got['per_utt'], want['per_utt']):
        assert (g['name'], g['text'], g['n_text']) == (w['name'], w['text'], w['n_text'])
        assert [(m['pos'], m['symbol'], m['kind']) for m in g['missed']] == \
            [(m['pos'], m['symbol'], m['kind']) for m in w['missed']]
        for gm, wm in zip(g['missed'], w['missed']):
            assert abs(gm['mass_steps'] - wm['mass_steps']) <= 1e-4 + 1e-3
        for k in ('coverage', 'coverage_winnable'):
            assert abs(g[k] - w[k]) <= 1e-4 + 1e-4, k
    for k in ('total_missed', 'total_structural', 'total_genuine_skip',
              'missed_symbol_hist', 'structural_symbol_hist', 'struct_thresh_steps'):
        assert got[k] == want[k], k


def test_draw_embd_sim_matches_jax(runs, tmp_path):
    out = str(tmp_path / 'sims')
    sims = draw_embd_sim.main(['--run_dir', runs['port_ac'], '--out_dir', out,
                               '--device', 'cpu'])
    assert set(sims) == {'E_text', 'E_tone', 'E_prds'}
    for key, sim in sims.items():
        want = jembd.cosine_sim(np.asarray(runs['tree'][key]))
        np.testing.assert_allclose(sim, want, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(sim, sim.T, atol=1e-5)
        np.testing.assert_allclose(np.diag(sim), 1.0, atol=1e-5)
        np.testing.assert_array_equal(np.load(os.path.join(out, f'{key}_sim.npy')), sim)
        assert os.path.getsize(os.path.join(out, f'{key}_sim.png')) > 0


def _key_of(spec):
    return jax.random.PRNGKey(zlib.crc32(np.ascontiguousarray(spec).tobytes()) & 0x7fffffff)


def test_bf16_ab_float32_column_matches_jax(runs, jax_tools_share, tmp_path, monkeypatch,
                                            capsys):
    """Both tools on the converted generator: the float32 metrics of each
    item within 1e-4 of the JAX tool's (the Griffin-Lim phase of an item
    drawn from one key on both sides); the bf16 column finite."""
    vocode_jax = jax_tools_share.vocode
    monkeypatch.setattr(jax_tools_share, 'vocode',
                        lambda spec, key=None: vocode_jax(spec, key=_key_of(spec)))
    vocode_port = Synthesizer.vocode

    def pinned(self, spec, theta=None):
        frames = -(-max(spec.shape[1], 64) // 64) * 64
        theta = 2.0 * jnp.pi * jax.random.uniform(_key_of(spec), (PCFG.audio.n_freq, frames))
        return vocode_port(self, spec, theta=torch.from_numpy(np.array(theta)))
    monkeypatch.setattr(Synthesizer, 'vocode', pinned)
    scored = {'jax': [], 'port': []}
    for who, metrics in (('jax', jmetrics), ('port', pmetrics)):
        def record(y, y_hat, cfg, real=metrics.evaluate_pair, out=scored[who]):
            out.append(real(y, y_hat, cfg))
            return out[-1]
        monkeypatch.setattr(metrics, 'evaluate_pair', record)
    monkeypatch.setattr(sys, 'argv', ['bf16_ab', '--data_dir', runs['data'], '--vocoder_dir',
                                      runs['jax_voc'], '--config', runs['jax_voc'],
                                      '--out', str(tmp_path / 'jax.json')])
    jbf16.main()
    res = bf16_ab.main(['--data_dir', runs['data'], '--vocoder_dir', runs['port_voc'],
                        '--config', runs['port_voc'], '--out', str(tmp_path / 'port.json'),
                        '--device', 'cpu'])
    capsys.readouterr()
    assert res['n_items'] == N_TEST and res['device'] == 'cpu'
    # per item: float32 then bfloat16 (the JAX side's second is its float32 again)
    assert len(scored['jax']) == len(scored['port']) == 2 * N_TEST
    for g, w in zip(scored['port'][::2], scored['jax'][::2]):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4, (k, g[k], w[k])
    assert all(np.isfinite(v) for d in res['per_dtype'].values() for v in d.values())
    assert np.isfinite(res['max_abs_waveform_deviation'])


def test_eval_vocoder_vs_gl_and_reports(runs, tmp_path):
    """The vocoder-against-Griffin-Lim evaluation on the converted
    generator (finite, both signals scored) and both sessions' reports."""
    ev = convergence_session.eval_vocoder_vs_gl(PCFG, runs['data'], runs['port_voc'],
                                                device='cpu')
    assert ev['n_items'] == N_TEST and isinstance(ev['gan_beats_gl'], bool)
    for tag in ('gl', 'gan'):
        assert set(ev[tag]) >= {'mstft', 'mcd', 'snr_db', 'pesq_proxy'}
        assert all(np.isfinite(v) for v in ev[tag].values())
    args = convergence_session.parser().parse_args(['--out_dir', str(tmp_path),
                                                    '--device', 'cpu'])
    steps = [10, 20]
    convergence_session._write_report(args, steps, [2.0, 1.0], [1.0, 0.5], [0.1, 0.05],
                                      steps, [9.0, 8.0], [7.0, 6.0], [0.5, 0.6],
                                      [0.4, 0.3], {'vocoder_vs_gl': ev})
    report = (tmp_path / 'README.md').read_text()
    assert 'Device: **cpu**' in report and 'GAN beats GL' in report
    dargs = decay_session.parser().parse_args(['--workdir', str(tmp_path), '--out_dir',
                                               str(tmp_path / 'decay')])
    os.makedirs(dargs.out_dir)
    row = {'step': 8, 'tf_ratio': 1.0, 'coverage': 0.5, 'min_coverage': 0.4,
           'mass_coverage': 0.9, 'diagonality': 0.8, 'held_out_mel_l1_item': 0.1,
           'held_out_stop_ce_item': 0.2, 'held_out_prds_accuracy': None}
    decay_session._write_report(dargs, {'recipe': {'tf_start_decay': 4, 'tf_decay': 8,
                                                   'batch_size': 2}, 'rows': [row]})
    assert '| 8 | 1.000 | **0.500** |' in (tmp_path / 'decay' / 'README.md').read_text()
