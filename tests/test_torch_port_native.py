"""The native DSP library (``native/ttsdsp.cpp``) in the port, on the CPU.

``data/native.py`` builds the library from the repo's source with the
host compiler at first use.  Its wrappers equal the JAX package's wrappers
run on the same library bit for bit (the JAX module is pointed at the
port's build by monkeypatching its ``_LIB``/``_LIB_TRIED``; nothing in the
JAX package is edited).  The native template's spectral convergence is
no worse than numpy's (mean over six signals, within 10%).  A failed
build raises with the compiler's output; concurrent first uses build once.
``inv_log_mag``, the vocoder dataset and its loader take the native
engine by default and numpy only when asked; dataset items with both
packages on the native library are bit-identical, and a finetune template
cached by one engine is read by the other.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu.audio import transforms as jT
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.data import native as jnative
from transtacos_retunegan_tpu.data import vocoder_data as jvd
from transtacos_retunegan_tpu_torch.audio import features as PF
from transtacos_retunegan_tpu_torch.audio import transforms as pT
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.data import native as pnative
from transtacos_retunegan_tpu_torch.data import vocoder_data as pvd
from transtacos_retunegan_tpu_torch.ops import build
from transtacos_retunegan_tpu_torch.tools.tone_corpus import write_corpus

pytestmark = pytest.mark.usefixtures('few_threads')
AU = PortConfig().audio
SC_TOL = 1.10


@pytest.fixture
def jax_on_port_lib(monkeypatch):
    """The JAX package's native wrappers on the port's build."""
    monkeypatch.setattr(jnative, '_LIB', pnative.lib())
    monkeypatch.setattr(jnative, '_LIB_TRIED', True)


def _signal(seed: int, frames: int = 48) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(AU.hop_length * frames) / AU.sample_rate
    return (0.5 * np.sin(2 * np.pi * (150 + 50 * seed) * t) + 0.2 * np.sin(2 * np.pi * 600 * t)
            + 0.01 * rng.randn(len(t))).astype(np.float32)


def test_wrappers_match_jax_bit_for_bit(jax_on_port_lib):
    y = _signal(0)
    mag = np.abs(PF.stft_np(y, 2048, 256, 1024)).astype(np.float32)
    log_mag = pT.get_mag(y[:-1], AU)
    cases = [
        (pnative.stft_mag(y, 2048, 256, 1024), jnative.stft_mag(y, 2048, 256, 1024)),
        (pnative.stft_mag(y[:777], 512, 128, 400), jnative.stft_mag(y[:777], 512, 128, 400)),
        (pnative.rms(y, 1024, 256), jnative.rms(y, 1024, 256)),
        (pnative.griffin_lim(mag, 3, AU), jnative.griffin_lim(mag, 3, AU)),
        (pnative.griffin_lim(mag, 4, AU, momentum=0.7, length=len(y) - 5, seed=9),
         jnative.griffin_lim(mag, 4, AU, momentum=0.7, length=len(y) - 5, seed=9)),
        (pnative.inv_log_mag(log_mag, AU, length=len(y) - 1),
         jnative.inv_log_mag(log_mag, AU, length=len(y) - 1)),
        (pnative.inv_log_mag(log_mag[1:], AU), jnative.inv_log_mag(log_mag[1:], AU)),
        (pT.inv_log_mag(log_mag, AU, length=len(y) - 1),
         jT.inv_log_mag(log_mag, JaxConfig().audio, length=len(y) - 1)),
    ]
    for i, (got, ref) in enumerate(cases):
        assert got.dtype == ref.dtype == np.float32, i
        np.testing.assert_array_equal(got, ref, err_msg=str(i))


def test_native_template_converges_like_numpy():
    """Spectral convergence ||(|STFT(w)| - M)|| / ||M|| against the
    power-raised target M, averaged over six signals."""
    sc = {'native': [], 'numpy': [], 'none': []}
    for seed in range(6):
        y = _signal(seed)[:-1]
        log_mag = pT.get_mag(y, AU)
        target = np.exp(log_mag.astype(np.float64)) ** AU.gl_power

        def conv(w):
            s = np.abs(PF.stft_np(w, AU.n_fft, AU.hop_length, AU.win_length, AU.window_fn))
            return np.linalg.norm(s - target) / np.linalg.norm(target)
        for engine in ('native', 'numpy'):
            w = pT.inv_log_mag(log_mag, AU, length=len(y), engine=engine)
            assert w.shape == y.shape and np.isfinite(w).all()
            sc[engine].append(conv(w))
        s = np.concatenate([np.zeros((1, log_mag.shape[1])), np.exp(log_mag[1:])]) ** AU.gl_power
        sc['none'].append(conv(pnative.griffin_lim(s.astype(np.float32), 0, AU, length=len(y))))
    native, numpy_, none = (float(np.mean(v)) for v in (sc['native'], sc['numpy'], sc['none']))
    assert native <= SC_TOL * numpy_, (native, numpy_)
    assert native < 0.5 * none, (native, none)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, 'BUILD', tmp_path / 'build')
    monkeypatch.setattr(build, '_LIBS', {})
    bad = tmp_path / 'broken.cpp'
    bad.write_text('extern "C" int f() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match='undefined_name'):
        build.load_host(bad)
    monkeypatch.setenv('CXX', str(tmp_path / 'no-such-compiler'))
    with pytest.raises(RuntimeError, match='cannot run the host compiler'):
        pnative.lib()
    with pytest.raises(RuntimeError, match='cannot run the host compiler'):
        pT.inv_log_mag(np.zeros((AU.n_freq, 4), np.float32), AU)
    assert pT.inv_log_mag(np.zeros((AU.n_freq, 4), np.float32), AU,
                          engine='numpy').shape == (3 * AU.hop_length,)


def test_concurrent_first_use_builds_once(tmp_path, monkeypatch):
    """Eight threads take the library at once (the loader's workers on
    their first template): one build, one library object."""
    monkeypatch.setattr(build, 'BUILD', tmp_path / 'build')
    monkeypatch.setattr(build, '_LIBS', {})
    got, errors = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def take():
            try:
                got.append(pnative.lib())
            except BaseException as e:       # surfaced by the assert below
                errors.append(e)
        threads = [threading.Thread(target=take) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 8 and len({id(x) for x in got}) == 1
    assert [p.suffix for p in (tmp_path / 'build').iterdir()] == ['.so']


def test_engine_is_the_callers_choice(monkeypatch):
    calls = []
    real = pnative.inv_log_mag
    monkeypatch.setattr(pnative, 'inv_log_mag', lambda *a, **k: calls.append(1) or real(*a, **k))
    log_mag = pT.get_mag(_signal(1, 8)[:-1], AU)
    pT.inv_log_mag(log_mag, AU)
    assert calls == [1]
    pT.inv_log_mag(log_mag, AU, engine='numpy')
    assert calls == [1]
    with pytest.raises(ValueError, match='engine'):
        pT.inv_log_mag(log_mag, AU, engine='fast')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Three train and one test tone of 0.25-1.2 s, with the acoustic
    preprocessor's ``mag-*.npy`` for the finetune mode."""
    base = str(tmp_path_factory.mktemp('tones'))
    write_corpus(base, AU, 3, 1, seed=2, min_s=0.25, max_s=1.2)
    for i in range(4):
        y = PF.load_wav(os.path.join(base, 'wavs', f'tone{i:04d}.wav'), AU)
        y = PF.align_wav(PF.trim_silence(y, AU), AU.hop_length)
        np.save(os.path.join(base, f'mag-tone{i:04d}.npy'), pT.get_specs(y[:-1], AU)[0])
    return base


def _copy(corpus, dst):
    shutil.copytree(corpus, dst, ignore=shutil.ignore_patterns('wavs'))
    return str(dst)


@pytest.mark.parametrize('finetune', [False, True], ids=['scratch', 'finetune'])
def test_dataset_items_on_the_native_library_match_jax(corpus, tmp_path, jax_on_port_lib,
                                                       finetune):
    jds = jvd.VocoderDataset('train', _copy(corpus, tmp_path / 'j'), JaxConfig(),
                             finetune=finetune)
    pds = pvd.VocoderDataset('train', _copy(corpus, tmp_path / 'p'), PortConfig(),
                             finetune=finetune)
    assert pds.engine == 'native'
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_template_cache_is_read_by_the_other_engine(corpus, tmp_path):
    data = _copy(corpus, tmp_path / 'd')
    native = pvd.VocoderDataset('test', data, PortConfig(), finetune=True)
    first = native[0]['tmpl']
    cached = [f for f in os.listdir(data) if f.startswith('tmpl')]
    assert len(cached) == 1
    numpy_ = pvd.VocoderDataset('test', data, PortConfig(), finetune=True, engine='numpy')
    np.testing.assert_array_equal(numpy_[0]['tmpl'], first)
    fresh = pvd.VocoderDataset('test', _copy(corpus, tmp_path / 'f'), PortConfig(),
                               finetune=True, engine='numpy')
    assert not np.array_equal(fresh[0]['tmpl'], first)


def test_loader_hands_the_engine_on(corpus, tmp_path):
    ds = pvd.VocoderDataset('train', _copy(corpus, tmp_path / 'l'), PortConfig())
    pvd.VocoderLoader(ds, 2, num_workers=1)
    assert ds.engine == 'native'
    pvd.VocoderLoader(ds, 2, num_workers=1, engine='numpy')
    assert ds.engine == 'numpy'
    with pytest.raises(ValueError, match='engine'):
        pvd.VocoderLoader(ds, 2, engine='fast')
    with pytest.raises(ValueError, match='engine'):
        pvd.VocoderDataset('train', str(tmp_path / 'l'), PortConfig(), engine='fast')
