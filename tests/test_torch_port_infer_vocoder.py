"""``serve/infer_vocoder.py`` on the CPU: ``vocode_mag_norm`` and
``roundtrip_wav`` equal the JAX package's functions on the same weights and
Griffin-Lim engine (numpy, and the native library on both sides; the
generator tolerance of ``test_torch_port_vocoder.py``, 1e-4), the CLI
vocodes a folder of one ``.npy`` and one ``.wav`` (what it writes is what
the functions return), a run without a checkpoint warns and takes seeded
weights, and the CLI defaults to the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from torch_port_common import reference_state_dict, vocoder_cfg_pair
from transtacos_retunegan_tpu.data import native as jnative
from transtacos_retunegan_tpu.models.generators import make_generator as jmake
from transtacos_retunegan_tpu.serve import infer_vocoder as jinfer
from transtacos_retunegan_tpu_torch import interop as pinterop
from transtacos_retunegan_tpu_torch.audio import features as PF
from transtacos_retunegan_tpu_torch.data import native as pnative
from transtacos_retunegan_tpu_torch.models.generators import make_generator
from transtacos_retunegan_tpu_torch.serve import infer_vocoder as pinfer
from transtacos_retunegan_tpu_torch.train import checkpoint as ckpt
from transtacos_retunegan_tpu_torch.weights import load_flax

pytestmark = pytest.mark.usefixtures('few_threads')
GEN_TOL_ATOL = 1e-4        # the generator tolerance of test_torch_port_vocoder.GEN_TOL


def _cfgs(ver):
    return vocoder_cfg_pair(generator_ver=ver)


@pytest.fixture(scope='module')
def vocoder_run(tmp_path_factory):
    """A run dir with seeded RefineGAN_small weights (small width) as the
    port's ``g_`` checkpoint, the same tree for the JAX side, a normalized
    mag and a wav."""
    jcfg, pcfg = _cfgs('RefineGAN_small')
    run = tmp_path_factory.mktemp('vocoder_run')
    module = make_generator(pcfg)
    tree = pinterop.import_generator_state_dict(
        reference_state_dict(module, pinterop.map_refinegan_small(), 21), 'RefineGAN_small')
    load_flax(module, tree)
    pcfg.save(str(run))
    ckpt.save_file(str(run / 'g_00000003'), {'generator': module.state_dict()})
    rng = np.random.RandomState(5)
    t = np.arange(256 * 23) / pcfg.audio.sample_rate
    wav = (0.4 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.randn(len(t))).astype(np.float32)
    mag_norm = np.clip(rng.rand(pcfg.audio.n_freq, 19) * 0.6 - 0.9, -4, 4).astype(np.float32)
    return jcfg, pcfg, str(run), tree, mag_norm, wav


class _Jitted:
    """A flax module whose ``apply`` is jitted (op by op it takes seconds)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames='train')


@pytest.mark.parametrize('engine', ['numpy', 'native'])
def test_infer_vocoder_matches_jax(vocoder_run, monkeypatch, engine):
    jcfg, pcfg, run, tree, mag_norm, wav = vocoder_run
    if engine == 'native':
        monkeypatch.setattr(jnative, '_LIB', pnative.lib())
        monkeypatch.setattr(jnative, '_LIB_TRIED', True)
    else:
        monkeypatch.setattr(jnative, 'available', lambda: False)
    gen = pinfer.load_generator(run, pcfg, 'cpu')
    params = jax.tree.map(jnp.asarray, tree)
    jgen = _Jitted(jmake(jcfg))
    for got, ref in ((pinfer.vocode_mag_norm(gen, mag_norm, pcfg, engine),
                      jinfer.vocode_mag_norm(jgen, params, mag_norm, jcfg)),
                     (pinfer.roundtrip_wav(gen, wav, pcfg, engine),
                      jinfer.roundtrip_wav(jgen, params, wav, jcfg))):
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=GEN_TOL_ATOL, rtol=0)


def test_infer_vocoder_cli(vocoder_run, tmp_path, capsys):
    _, pcfg, run, _, mag_norm, wav = vocoder_run
    src, dst = tmp_path / 'in', tmp_path / 'out'
    src.mkdir()
    np.save(src / 'mag-a.npy', mag_norm)
    PF.save_wav(wav, str(src / 'b.wav'), pcfg.audio)
    (src / 'notes.txt').write_text('skipped')
    pinfer.main(['--run_dir', run, '--input_dir', str(src), '--output_dir', str(dst),
                 '--device', 'cpu'])
    assert sorted(os.listdir(dst)) == ['b.gen.wav', 'mag-a.gen.wav']
    gen = pinfer.load_generator(run, pcfg, 'cpu')
    np.testing.assert_allclose(PF.load_wav(str(dst / 'mag-a.gen.wav'), pcfg.audio),
                               pinfer.vocode_mag_norm(gen, mag_norm, pcfg), atol=1e-6)
    assert len(PF.load_wav(str(dst / 'b.gen.wav'), pcfg.audio)) == len(
        PF.align_wav(wav, pcfg.audio.hop_length))
    assert 'warning' not in capsys.readouterr().out


def test_infer_vocoder_without_checkpoint_warns(tmp_path, capsys):
    _, pcfg = _cfgs('RefineGAN_small')
    gen = pinfer.load_generator(str(tmp_path), pcfg, 'cpu')
    assert 'no g_* checkpoint' in capsys.readouterr().out
    assert not gen.training


def test_infer_vocoder_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    args = pinfer.parser().parse_args(['--run_dir', str(tmp_path), '--input_dir',
                                       str(tmp_path), '--output_dir', str(tmp_path)])
    assert args.device == 'cuda' and args.gl_engine == 'native'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pinfer.main(['--run_dir', str(tmp_path), '--input_dir', str(tmp_path),
                     '--output_dir', str(tmp_path / 'o')])
