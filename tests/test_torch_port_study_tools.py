"""The port's training-quality study tools against the JAX package's, on
their host-side parts: the decay session's teacher-forcing mirror, the
coverage diagnosis, the variant ranking over the committed evidence, the
per-item held-out losses, the DSP studies, the sanity corpus and configs,
and the log lines of both port trainers that the sessions parse.

Tolerances: ``tf_ratio_at`` 1e-6 (float64 against the port's float32
schedule); ``item_masked_losses`` 1e-6 (float32 sums in another order);
the DSP studies 1e-6 relative (the same numpy on each package's copy of
the audio modules); everything else equal.
"""

import dataclasses
import hashlib
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from test_torch_port_imports import FILES
from torch_port_common import acoustic_cfg_pair, write_npy_corpus
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.tools import convergence_session as jcs
from transtacos_retunegan_tpu.tools import coverage_diagnosis as jcov
from transtacos_retunegan_tpu.tools import decay_session as jdecay
from transtacos_retunegan_tpu.tools import dsp_studies as jdsp
from transtacos_retunegan_tpu.tools import sanity_train as jsanity
from transtacos_retunegan_tpu.tools import variant_ranking as jrank
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.tools import (bf16_ab, convergence_session,
                                                  coverage_diagnosis, decay_session,
                                                  draw_embd_sim, dsp_studies, sanity_spread,
                                                  sanity_train, variant_ranking)
from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus
from transtacos_retunegan_tpu_torch.train.schedules import teacher_forcing_ratio

pytestmark = pytest.mark.usefixtures('few_threads')

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOLS = {'sanity_train': sanity_train, 'convergence_session': convergence_session,
         'decay_session': decay_session, 'variant_ranking': variant_ranking,
         'coverage_diagnosis': coverage_diagnosis, 'draw_embd_sim': draw_embd_sim,
         'dsp_studies': dsp_studies, 'bf16_ab': bf16_ab, 'sanity_spread': sanity_spread}


# ---------------------------------------------------------------------------
# decay_session.tf_ratio_at
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('step', [0, 99, 100, 150, 200, 299, 300, 1000])
def test_tf_ratio_at_mirrors_both_schedules(step):
    """tests/test_round5_tools.py's steps: the port's host mirror equals the
    JAX tool's and the port's ``teacher_forcing_ratio``."""
    hp = dataclasses.replace(PortConfig().acoustic, tf_start_decay=100, tf_decay=200)
    jhp = dataclasses.replace(JaxConfig().acoustic, tf_start_decay=100, tf_decay=200)
    got = decay_session.tf_ratio_at(step, hp)
    assert abs(got - jdecay.tf_ratio_at(step, jhp)) < 1e-6
    assert abs(got - teacher_forcing_ratio(step, hp)) < 1e-6


# ---------------------------------------------------------------------------
# coverage_diagnosis.diagnose_alignment
# ---------------------------------------------------------------------------

def _round5_cases():
    a = np.zeros((4, 6))
    a[0, :3] = [0.6, 0.6, 0.5]
    a[3, 3:] = [0.5, 0.6, 0.6]
    a[1] = 0.4
    a[2, :3] = 0.1
    yield 'structural_vs_genuine', a, ['a', 'b', 'c', 'd']
    yield 'full_coverage', np.eye(3), list('abc')
    for seed in range(4):
        r = np.random.RandomState(seed)
        n, t = r.randint(3, 20), r.randint(2, 30)
        logits = 3.0 * r.randn(n, t)
        a = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
        yield f'random{seed}', a, [f's{i}' for i in range(n - seed % 2)]


@pytest.mark.parametrize('name,align,symbols', list(_round5_cases()),
                         ids=lambda x: x if isinstance(x, str) else '')
def test_diagnose_alignment_matches_jax(name, align, symbols):
    """Every field, per-token kinds included, as the JAX tool's (short
    symbol lists give '?' on both sides)."""
    for thresh in (1.0, 0.5):
        got = coverage_diagnosis.diagnose_alignment(align, symbols, thresh)
        assert got == jcov.diagnose_alignment(align, symbols, thresh)
    if name == 'structural_vs_genuine':
        kinds = {m['symbol']: m['kind'] for m in got['missed']}
        assert kinds == {'b': 'genuine_skip', 'c': 'structural'}


# ---------------------------------------------------------------------------
# variant_ranking over the committed evidence
# ---------------------------------------------------------------------------

def _snapshot(*dirs):
    out = {}
    for d in dirs:
        for p in sorted((ROOT / d).rglob('*')):
            if p.is_file():
                out[str(p.relative_to(ROOT))] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def _table_rows(md: str):
    return [ln for ln in md.splitlines() if ln.startswith('| ') or 'reproduced' in ln]


def test_variant_ranking_matches_jax_and_leaves_the_evidence(tmp_path, monkeypatch, capsys):
    """Both tools over ``docs/convergence_r5`` (read only) into ``tmp_path``
    give the same rows; ``docs/`` and ``img/`` are unchanged."""
    before = _snapshot('docs', 'img')
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, 'argv', ['variant_ranking', '--base', 'docs/convergence_r5',
                                      '--out', str(tmp_path / 'jax.md')])
    jrank.main()
    rows = variant_ranking.main(['--base', 'docs/convergence_r5',
                                 '--out', str(tmp_path / 'port.md'), '--device', 'cpu'])
    capsys.readouterr()
    want = _table_rows((tmp_path / 'jax.md').read_text())
    assert len(want) > 3 and _table_rows((tmp_path / 'port.md').read_text()) == want
    assert [r['variant'] for r in rows] == [ln.split(' | ')[0][2:] for ln in want[1:-1]]
    assert _snapshot('docs', 'img') == before
    git = subprocess.run(['git', 'status', '--porcelain', 'docs', 'img'], cwd=ROOT,
                         capture_output=True, text=True)
    if git.returncode == 0:
        assert git.stdout == ''


# ---------------------------------------------------------------------------
# convergence_session.item_masked_losses
# ---------------------------------------------------------------------------

def _masked_inputs(seed, r, b=3, t_steps=8, m=5):
    rng = np.random.RandomState(seed)
    t_pad = t_steps * r
    batch = {'spec_lengths': rng.randint(1, t_pad, b).astype(np.int32),
             'mel_targets': rng.randn(b, t_pad, m).astype(np.float32),
             'mag_targets': rng.randn(b, t_pad, m + 2).astype(np.float32),
             'stop_token_targets': (rng.rand(b, t_pad) > 0.5).astype(np.float32)}
    out = {'mel_outputs': rng.randn(b, t_pad, m).astype(np.float32),
           'mag_outputs': rng.randn(b, t_pad, m + 2).astype(np.float32),
           'stop_token_outputs': (5 * rng.randn(b, t_pad)).astype(np.float32)}
    return out, batch


def _both_masked(out, batch):
    got = convergence_session.item_masked_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, PortConfig())
    want = jcs.item_masked_losses({k: jnp.asarray(v) for k, v in out.items()},
                                  {k: jnp.asarray(v) for k, v in batch.items()}, JaxConfig())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    return {k: float(v) for k, v in got.items()}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_item_masked_losses_match_jax(seed):
    r = PortConfig().acoustic.outputs_per_step
    _both_masked(*_masked_inputs(seed, r))


def test_item_masked_losses_ignore_the_poisoned_tail():
    """tests/test_tools.py's case: a short row's tail beyond its own
    round_up(len + 1, r) moves no per-item loss, in both packages."""
    r = PortConfig().acoustic.outputs_per_step
    b, t_pad, m = 2, 8 * r, 3
    batch = {'spec_lengths': np.array([2 * r - 1, 8 * r - 1], np.int32),
             'mel_targets': np.zeros((b, t_pad, m), np.float32),
             'mag_targets': np.zeros((b, t_pad, m), np.float32),
             'stop_token_targets': np.ones((b, t_pad), np.float32)}
    out = {'mel_outputs': np.zeros((b, t_pad, m), np.float32),
           'mag_outputs': np.zeros((b, t_pad, m), np.float32),
           'stop_token_outputs': np.full((b, t_pad), 50.0, np.float32)}
    clean = _both_masked(out, batch)
    assert clean['mel_l1'] == pytest.approx(0.0, abs=1e-6)
    assert clean['stop_ce'] == pytest.approx(0.0, abs=1e-6)
    bad = dict(out, mel_outputs=out['mel_outputs'].copy(),
               stop_token_outputs=out['stop_token_outputs'].copy())
    bad['mel_outputs'][0, 2 * r:] = 7.0
    bad['stop_token_outputs'][0, 2 * r:] = -50.0
    poisoned = _both_masked(bad, batch)
    for k in ('mel_l1', 'stop_ce'):
        assert poisoned[k] == pytest.approx(clean[k], abs=1e-6)


# ---------------------------------------------------------------------------
# dsp_studies
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def dsp_runs():
    sig = dsp_studies._test_signal(PortConfig().audio, seconds=1.0)
    assert np.array_equal(sig, jdsp._test_signal(JaxConfig().audio, seconds=1.0))
    return sig, dsp_studies.run_all(PortConfig().audio, sig), jdsp.run_all(JaxConfig().audio, sig)


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', v


def test_dsp_studies_match_jax(dsp_runs):
    _, got, want = dsp_runs
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys() and len(got) > 20
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_dsp_griffinlim_momentum_helps(dsp_runs):
    out = dsp_runs[1]['griffinlim']
    assert out['iters=4,momentum=0.7'] < out['iters=4,momentum=0.0'] * 1.2
    assert out['iters=30,momentum=0.0'] < out['iters=4,momentum=0.0']


def test_dsp_phase_recovery_ordering(dsp_runs):
    out = dsp_runs[1]['phase_recovery']
    assert out['istft_roundtrip'] < 1e-6
    assert out['mag_only_gl'] > out['istft_roundtrip']


def test_dsp_downsample_avgpool_removes_hf(dsp_runs):
    r = np.random.RandomState(1)
    noisy = dsp_runs[0] + 0.2 * r.randn(len(dsp_runs[0])).astype(np.float32)
    out = dsp_studies.study_downsample(PortConfig().audio, noisy)
    assert out['avgpool_hf_ratio'] < out['orig_hf_ratio']


def test_dsp_istft_iteration_stable(dsp_runs):
    out = dsp_studies.study_istft_iteration(PortConfig().audio, dsp_runs[0], n_iter=10)
    assert out['iter_10'] < 1e-3


# ---------------------------------------------------------------------------
# sanity_train: corpus and configs
# ---------------------------------------------------------------------------

def test_sanity_corpus_is_the_jax_corpus(tmp_path):
    """``build_corpus`` writes the JAX tool's metadata and wavs, byte for
    byte, and the same preprocessed features."""
    jax_dir = jsanity.build_corpus(str(tmp_path / 'jax'), JaxConfig())
    port_dir = sanity_train.build_corpus(str(tmp_path / 'port'), PortConfig())
    for rel in ['metadata.csv'] + [f'wavs/u{i}.wav' for i in range(len(jsanity.PINYINS))]:
        assert (tmp_path / 'port' / rel).read_bytes() == (tmp_path / 'jax' / rel).read_bytes(), rel
    for split in ('train.txt', 'test.txt'):
        assert (pathlib.Path(port_dir) / split).read_text() == \
            (pathlib.Path(jax_dir) / split).read_text()
    names = sorted(f for f in os.listdir(jax_dir) if f.endswith('.npy'))
    assert names == sorted(f for f in os.listdir(port_dir) if f.endswith('.npy'))
    for f in names:
        np.testing.assert_array_equal(np.load(os.path.join(port_dir, f)),
                                      np.load(os.path.join(jax_dir, f)), err_msg=f)


def test_sanity_configs_are_the_jax_configs():
    assert sanity_train.PINYINS == jsanity.PINYINS
    for fn in ('tiny_config', 'tiny_vocoder_config'):
        got = dataclasses.asdict(getattr(sanity_train, fn)(PortConfig()))
        want = dataclasses.asdict(getattr(jsanity, fn)(JaxConfig()))
        assert got == want, fn


# ---------------------------------------------------------------------------
# the trainers' log lines
# ---------------------------------------------------------------------------

# the JAX tools' patterns: convergence_session.py:374-411, decay_session.py:
# 207-212, sanity_train.py:92-94 and :139
ACOUSTIC_PATTERNS = (r'step (\d+) \[', r'\[(\d+\.\d+) s/step', r'loss (\d+\.\d+),',
                     r'mel (\d+\.\d+)', r'stop (\d+\.\d+)', r'tfr (\d+\.\d+)',
                     r'loss (\d+\.\d+)')
GAN_PATTERNS = (r'\[(\d+) \(', r'mstft: (\d+\.\d+)', r'total gen: (\d+\.\d+)',
                r'sc_s_r: (-?\d+\.\d+)', r'sc_s_g: (-?\d+\.\d+)')


def test_trainer_log_lines_parse(tmp_path, monkeypatch):
    """Both port trainers' CLIs, 2 steps each on the CPU through the
    sessions' ``run_cli``, print one line per step that every pattern the
    JAX tools read parses (the acoustic steps 1 and 2 at ratio 1)."""
    # the CLIs' processes take two threads each, as ``few_threads`` gives
    # this module: with a pool of a thread per core beside the other test
    # processes, the two runs took 2.7x as long (227.5 s against 82.9 s in
    # a whole run of the suite on 8 cores)
    monkeypatch.setenv('OMP_NUM_THREADS', '2')
    monkeypatch.setenv('MKL_NUM_THREADS', '2')
    _, pcfg = acoustic_cfg_pair(remat_decoder=False)
    pcfg = dataclasses.replace(pcfg, audio=dataclasses.replace(pcfg.audio, segment_size=2048),
                               vocoder=dataclasses.replace(
                                   pcfg.vocoder, upsample_initial_channel=32,
                                   disc_width_mult=0.25, msd_layers=1, mpd_periods=(3,),
                                   multi_stft_params=((512, 256, 60),), d_train_times=1,
                                   batch_size=2, num_workers=1))
    cfg_path = pcfg.save(str(tmp_path / 'cfg'))
    (tmp_path / 'npy').mkdir()
    corpus = write_npy_corpus(tmp_path / 'npy')
    out = convergence_session.run_cli(convergence_session.ACOUSTIC_CLI, [
        '--data_dir', corpus, '--log_path', str(tmp_path / 'ac'), '--config', cfg_path,
        '--device', 'cpu', '--max_steps', '2', '--log_interval', '1',
        '--checkpoint_interval', '100', '--summary_interval', '100'], timeout=600)
    for pat in ACOUSTIC_PATTERNS:
        assert len(re.findall(pat, out)) == 2, pat
    assert re.findall(ACOUSTIC_PATTERNS[0], out) == ['1', '2']
    assert convergence_session.parse_series(out, r'tfr (\d+\.\d+)') == [1.0, 1.0]
    tones = str(tmp_path / 'tones')
    write_corpus(tones, pcfg.audio, 4, 2, seed=1, min_s=0.25, max_s=1.2)
    out = convergence_session.run_cli(convergence_session.VOCODER_CLI, [
        '--data_dir', tones, '--log_path', str(tmp_path / 'vo'), '--config', cfg_path,
        '--device', 'cpu', '--epochs', '1', '--stdout_interval', '1',
        '--checkpoint_interval', '100', '--summary_interval', '100',
        '--validation_interval', '100'], timeout=600)
    for pat in GAN_PATTERNS:
        assert len(re.findall(pat, out)) == 2, pat
    assert re.findall(GAN_PATTERNS[0], out) == ['1', '2']
    assert all(np.isfinite(convergence_session.parse_series(out, p)).all()
               for p in GAN_PATTERNS[1:])


# ---------------------------------------------------------------------------
# the tools' surfaces
# ---------------------------------------------------------------------------

def test_walk_covers_the_study_tools():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for name in TOOLS:
        assert f'transtacos_retunegan_tpu_torch/tools/{name}.py' in names


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_no_default_output_under_the_evidence(name):
    """No tool writes into ``docs/`` or ``img/`` by default (the JAX
    package's committed evidence); the outputs default under
    ``runs/torch_port/``."""
    module = TOOLS[name]
    if not hasattr(module, 'parser'):        # dsp_studies prints only
        return
    outputs = {a.dest: a.default for a in module.parser()._actions
               if a.dest in ('out', 'out_dir', 'log_path')}
    for dest, default in outputs.items():
        assert default.startswith('runs/torch_port/'), (dest, default)
    for a in module.parser()._actions:
        if isinstance(a.default, str):
            assert not a.default.startswith(('img', 'docs')) or a.dest == 'base', a.dest


@pytest.mark.parametrize('name,argv', [
    ('sanity_train', []), ('sanity_spread', []), ('convergence_session', []),
    ('decay_session', ['--workdir', 'unused']),
    ('coverage_diagnosis', ['--data_dir', 'unused', '--acoustic_dir', 'unused']),
    ('draw_embd_sim', ['--run_dir', 'unused']), ('variant_ranking', []),
    ('bf16_ab', ['--data_dir', 'unused', '--vocoder_dir', 'unused'])])
def test_cuda_by_default_and_no_fallback(name, argv, tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``; without a card the tool raises
    before it writes anything (``dsp_studies`` needs no device)."""
    assert not hasattr(dsp_studies, 'parser')
    assert TOOLS[name].parser().parse_args(argv).device == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TOOLS[name].main(argv)
    assert os.listdir(tmp_path) == []
