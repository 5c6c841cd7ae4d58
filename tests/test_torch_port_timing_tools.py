"""The port's timing and equivalence tools (``acoustic_step_ab``,
``pallas_equivalence``, ``profile_stages``, ``acoustic_step_trace``,
``train_scaling``, ``bench_precision``) on the CPU, against the JAX tools.

Held here: ``make_batch``'s arrays bit for bit; ``pallas_equivalence``'s
reference (the stepped decoder cell) against the JAX tool's ``run_flax``
at the default dims for 8 steps, within 1e-5, on JAX's ``PRNGKey(0)``
weights (which ``flax_acoustic_init`` draws within 1e-6, its orthogonal
leaves 1e-5); its exit on a perturbed path; each tool's JSON keys (or
stage names) against the JAX tool's, listed here, with the keys the port
adds named; ``mfu_pct`` null on a card without a peak; every tool raising
for ``cuda`` without a card; outputs under ``runs/torch_port/`` and
nothing under ``docs/``.  Timings here are CPU numbers of small
configurations and are not held.
"""

import dataclasses
import importlib
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu_torch import config as port_config
from transtacos_retunegan_tpu_torch import jax_random, weights
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models import decoder as dec
from transtacos_retunegan_tpu_torch.tools import acoustic_step_ab as ab
from transtacos_retunegan_tpu_torch.tools import acoustic_step_trace as trace
from transtacos_retunegan_tpu_torch.tools import bench_precision as bp
from transtacos_retunegan_tpu_torch.tools import pallas_equivalence as pe
from transtacos_retunegan_tpu_torch.tools import profile_stages as ps
from transtacos_retunegan_tpu_torch.tools import train_scaling as ts

pytestmark = pytest.mark.usefixtures('few_threads')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ('acoustic_step_ab', 'pallas_equivalence', 'profile_stages', 'acoustic_step_trace',
         'train_scaling', 'bench_precision')
DECODE_TOL = 1e-5
FAST = ['--warm', '0', '--steps', '1', '--trials', '1', '--device', 'cpu']

# the JSON keys of the JAX tools (their ``result``/``out`` dicts)
JAX_KEYS = {
    'acoustic_step_ab': {'device', 'geometry', 'forward_only_ms_at_unroll1', 'by_unroll'},
    'pallas_equivalence': {'device', 'platform', 'interpret', 'params_from', 'config',
                           'shapes', 'atol_f32', 'runs'},
    'acoustic_step_trace': {'device', 'geometry', 'note', 'stages_ms', 'derived'},
    'train_scaling': {'device', 'acoustic_geometry', 'gan_geometry', 'gan_compute_dtype',
                      'acoustic', 'gan', 'gan_stages', 'derived'},        # gan_stages: --stages
    'bench_precision': {'device', 'forward_ms_float32', 'gan_step_ms_float32',
                        'forward_ms_bfloat16', 'gan_step_ms_bfloat16', 'forward_dev_max',
                        'forward_dev_mean', 'forward_speedup', 'gan_speedup'},
}
# bench_precision's keys under --skip_gan (its GAN leg is train_scaling's step)
SKIP_GAN = {'gan_step_ms_float32', 'gan_step_ms_bfloat16', 'gan_speedup'}
# what the port adds: the FLOP count's scope (the JAX tool reads XLA's)
PORT_ADDS = {'train_scaling': {'flops_counted'}}
EQUIVALENCE_RUNS = {'fused_per_step_f32', 'fused_full_f32', 'fused_full_early_exit_f32',
                    'fused_full_bf16_vs_f32_scan'}
DELTA_KEYS = {'mel_outputs', 'stop_token_outputs', 'alignments', 'out_lengths_equal'}
TRACE_STAGES = {'full_train_step', 'full_train_step_hoisted', 'forward_loss',
                'encoder_forward', 'decode_scan_forward', 'decode_scan_fwd_bwd',
                'decode_scan_fast_forward', 'decode_scan_fast_fwd_bwd', 'posnet_forward',
                'optimizer_apply'}
TRACE_DERIVED = {'backward_minus_forward_ms', 'decode_scan_share_of_step',
                 'fast_cell_scan_speedup', 'hoisted_step_speedup'}
PROFILE_STAGES = ('acoustic: encoder + fused decode + posnet',
                  'vocoder: natural-scale -> mel + GL template',
                  'vocoder: generator forward',
                  'train: GAN step (D x2 + G, bs 16)',
                  'train: acoustic step (bs 16 x 400 frames)')


@pytest.fixture(scope='module')
def jax_tools(tmp_path_factory):
    """The JAX tools ``acoustic_step_ab`` and ``pallas_equivalence``,
    imported with their persistent compile cache in a temporary folder and
    the JAX settings they change put back."""
    keys = ('jax_compilation_cache_dir', 'jax_persistent_cache_min_compile_time_secs')
    saved = {k: getattr(jax.config, k) for k in keys}
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp('jax_tools'))
    try:
        mods = [importlib.import_module(f'transtacos_retunegan_tpu.tools.{m}')
                for m in ('acoustic_step_ab', 'pallas_equivalence')]
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def small_tool_cfg():
    """Tiny acoustic dims (the tools' ``--tiny``) and a small vocoder:
    2048-sample segments, B=2, slim discriminators."""
    base = PortConfig()
    return dataclasses.replace(
        base, audio=dataclasses.replace(base.audio, segment_size=2048),
        acoustic=dataclasses.replace(base.acoustic, **ab.TINY),
        vocoder=dataclasses.replace(base.vocoder, batch_size=2, upsample_initial_channel=32,
                                    multi_stft_params=((512, 256, 60),),
                                    disc_width_mult=0.25, msd_layers=1, mpd_periods=(3,)))


@pytest.mark.parametrize('geometry', [(16, 32, 400), (2, 12, 20)])
def test_make_batch_matches_jax(jax_tools, geometry):
    b, n_txt, t = geometry
    want = jax_tools[0].make_batch(JaxConfig(), b=b, n_txt=n_txt, t=t)
    got = ab.make_batch(PortConfig(), b=b, n_txt=n_txt, t=t)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k


def test_unrolls_other_than_one_are_refused():
    with pytest.raises(SystemExit, match='scan_unroll'):
        ab.main(['--unrolls', '5', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='scan_unroll'):
        ab.main(['--unrolls', '1,5,10', '--device', 'cpu'])


def test_reference_decode_matches_run_flax(jax_tools):
    """The stepped cell against the JAX tool's scanned cell at the default
    dims: the same seeded inputs, JAX's ``PRNGKey(0)`` weights, 8 steps."""
    jpe = jax_tools[1]
    jcfg, pcfg, steps = JaxConfig(), PortConfig(), 8
    attn = pe.inputs(pcfg, 1, 80, 'cpu')
    jattn = jpe.dec.AttentionParams(*(jax.numpy.asarray(t.numpy()) for t in attn))
    cell = jpe.dec.make_scanned_cell(jcfg, 'infer')
    params = jax.jit(lambda key: cell.init(
        {'params': key}, (jpe.dec.init_carry(1, 80, jcfg), jattn, jax.numpy.asarray(0.0)),
        {'target_prev': jax.numpy.zeros((steps, 1, jcfg.audio.n_mel))})['params'])(
            jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, dict(params))
    drawn, _ = pe.cell_weights(pcfg, None, 'cpu')
    got = weights.flatten(weights.to_flax(drawn, drawn.state_dict())[0])
    for path, leaf in weights.flatten(tree).items():
        ortho = path[-1] == 'kernel' and path[-2] in ('hr', 'hz', 'hn')
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=1e-5 if ortho else 1e-6,
                                   err_msg='/'.join(path))
    ref = jpe.run_flax(jcfg, params, jattn, steps, 1)
    port = pe.to_numpy(dec.decode(weights.load_flax(dec.DecoderCell(pcfg), tree), attn, steps))
    for k in pe.OUTPUTS:
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=DECODE_TOL, err_msg=k)
    assert np.array_equal(port['out_lengths'], ref['out_lengths'])


def test_pallas_equivalence_on_the_cpu(tmp_path, monkeypatch):
    """The plain versions against the stepped cell (``--device cpu``, the
    JAX tool's ``--interpret``), written under ``runs/torch_port/``."""
    monkeypatch.chdir(tmp_path)
    result = pe.main(['--device', 'cpu', '--steps', '8'])
    assert set(result) == JAX_KEYS['pallas_equivalence']
    assert set(result['runs']) == EQUIVALENCE_RUNS
    for tag, d in result['runs'].items():
        extra = {'trimmed_to_frames'} if 'early_exit' in tag else set()
        assert set(d) == DELTA_KEYS | extra
    for tag in pe.F32_RUNS:
        assert result['runs'][tag]['out_lengths_equal']
        assert max(result['runs'][tag][k] for k in pe.OUTPUTS) <= 2e-4
    assert result['interpret'] and result['shapes']['frames'] == 40
    assert os.path.exists(tmp_path / 'runs' / 'torch_port' / 'pallas_equivalence.json')


def test_pallas_equivalence_exits_non_zero_on_a_perturbed_path(tmp_path, monkeypatch):
    from transtacos_retunegan_tpu_torch.ops import fused_decoder as F
    real = F.fused_decode_full

    def perturbed(*args, **kw):
        out = real(*args, **kw)
        return dict(out, mel_outputs=out['mel_outputs'] + 1e-3)
    monkeypatch.setattr(F, 'fused_decode_full', perturbed)
    with pytest.raises(SystemExit, match='equivalence FAILED: fused_full_f32.mel_outputs'):
        pe.main(['--device', 'cpu', '--steps', '8', '--out', str(tmp_path / 'e.json')])


def test_acoustic_step_tools_on_the_cpu(tmp_path, monkeypatch):
    """``acoustic_step_ab`` and ``acoustic_step_trace`` at ``--tiny``:
    the JAX tools' keys and stages, finite times, outputs where asked."""
    monkeypatch.chdir(tmp_path)
    got = ab.main(['--tiny'] + FAST)
    assert set(got) == JAX_KEYS['acoustic_step_ab']
    assert set(got['by_unroll']) == {'1'} and set(got['by_unroll']['1']) == {'step_ms'}
    got = trace.main(['--tiny'] + FAST)
    assert set(got) == JAX_KEYS['acoustic_step_trace']
    assert set(got['stages_ms']) == TRACE_STAGES and set(got['derived']) == TRACE_DERIVED
    assert all(np.isfinite(v) and v > 0 for v in got['stages_ms'].values())
    assert sorted(os.listdir(tmp_path / 'runs' / 'torch_port')) == [
        'acoustic_step_ab.json', 'acoustic_step_trace.json']


def test_train_scaling_and_bench_precision_on_the_cpu(tmp_path, monkeypatch):
    """Both GAN tools on a small configuration: the JAX tools' keys (and
    what the port adds), ``mfu_pct`` null on the CPU; ``train_scaling``
    without ``--stages`` and ``bench_precision`` with ``--skip_gan`` (the
    GAN stages and both tools' GAN legs run on the card, in
    ``chip_smoke.py``)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ts, 'Config', small_tool_cfg)
    got = ts.main(['--tiny', '--batches', '2'] + FAST)
    assert set(got) == JAX_KEYS['train_scaling'] - {'gan_stages'} | PORT_ADDS['train_scaling']
    assert set(got['acoustic']['2']) == {'step_ms', 'samples_per_s', 'frames_per_s',
                                         'mfu_pct', 'flops_per_step'}
    assert set(got['gan']['2']) == {'step_ms', 'samples_per_s', 'audio_s_per_s', 'mfu_pct',
                                    'flops_per_step'}
    assert got['acoustic']['2']['flops_per_step'] > 0 and got['gan']['2']['flops_per_step'] > 0
    assert got['acoustic']['2']['mfu_pct'] is None and got['gan']['2']['mfu_pct'] is None
    assert os.listdir(tmp_path / 'runs' / 'torch_port') == ['train_scaling.json']

    monkeypatch.setattr(port_config, 'Config', small_tool_cfg)
    got = bp.main(['--steps', '1', '--trials', '1', '--device', 'cpu', '--skip_gan'])
    assert set(got) == JAX_KEYS['bench_precision'] - SKIP_GAN
    assert 0 < got['forward_dev_max'] < 1


def test_mfu_is_null_on_a_card_without_a_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda *a: 'NVIDIA Unknown GPU')
    assert ts.peak_flops(torch.device('cuda'), 'float32') is None
    assert ts.mfu(10 ** 12, 1.0, ts.peak_flops(torch.device('cuda'), 'bfloat16')) is None
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda *a: 'NVIDIA H100 80GB HBM3')
    assert ts.peak_flops(torch.device('cuda'), 'float32') == 66.9e12
    assert ts.mfu(66.9e12, 1.0, ts.peak_flops(torch.device('cuda'), 'float32')) == 100.0


def test_profile_stages_names_the_jax_tools_stages():
    assert ps.STAGES == PROFILE_STAGES


@pytest.mark.parametrize('tool', TOOLS)
def test_every_tool_defaults_to_cuda_and_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mod = importlib.import_module(f'transtacos_retunegan_tpu_torch.tools.{tool}')
    assert mod.parser().get_default('device') == 'cuda'
    out = mod.parser().get_default('out')
    assert out is None or out.startswith('runs/torch_port/')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main([])


def test_nothing_is_written_under_docs():
    """The JAX tools' records in ``docs/`` stay as committed."""
    out = subprocess.run(['git', 'status', '--porcelain', '--', 'docs'], cwd=REPO,
                         capture_output=True, text=True)
    if out.returncode != 0:
        pytest.skip('not a git checkout')
    assert out.stdout == ''
