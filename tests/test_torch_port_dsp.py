"""DSP port (torch.stft / irfft based) against the JAX DFT-matmul DSP.

Tolerances: the two sides compute the same transforms by different
algorithms (FFT vs windowed-DFT matmul) in float32, so single transforms
agree to ~1e-6 of their peak; Griffin-Lim repeats analysis and synthesis
and renormalises the phase, so its tolerance is looser (see each test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import few_threads  # noqa: F401
from transtacos_retunegan_tpu.audio import dsp as jdsp
from transtacos_retunegan_tpu.config import AudioConfig as JAudio
from transtacos_retunegan_tpu_torch.audio import dsp as tdsp
from transtacos_retunegan_tpu_torch.config import AudioConfig as TAudio

pytestmark = pytest.mark.usefixtures('few_threads')

JA, TA = JAudio(), TAudio()
HOP, WIN, NFFT = JA.hop_length, JA.win_length, JA.n_fft


def _signal(n=256 * 24 - 1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / JA.sample_rate
    return (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n)).astype(np.float32)


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
    assert err < rel, err


def test_stft_ri_matches():
    y = _signal()
    jr, ji = jdsp.stft_ri(jnp.asarray(y), NFFT, HOP, WIN, 'hann')
    tr, ti = tdsp.stft_ri(torch.from_numpy(y), NFFT, HOP, WIN, 'hann')
    _close(tr, jr, 1e-5)
    _close(ti, ji, 1e-5)


@pytest.mark.parametrize('length', [None, 256 * 20 - 1])
def test_istft_ri_matches(length):
    rng = np.random.RandomState(1)
    re = rng.randn(2, JA.n_freq, 20).astype(np.float32)
    im = rng.randn(2, JA.n_freq, 20).astype(np.float32)
    j = jdsp.istft_ri(jnp.asarray(re), jnp.asarray(im), HOP, WIN, 'hann', length)
    t = tdsp.istft_ri(torch.from_numpy(re), torch.from_numpy(im), HOP, WIN,
                      'hann', length)
    _close(t, j, 1e-5)


def _theta(shape, seed=3):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(2.0 * jnp.pi * jax.random.uniform(key, shape))


@pytest.mark.parametrize('momentum', [0.0, 0.7])
def test_griffin_lim_same_phase(momentum):
    """Same magnitude and initial phase: 4 projections; 1e-4 of the peak
    leaves room for the FFT-vs-matmul rounding the iterations carry."""
    y = _signal()
    mag = np.abs(np.asarray(jdsp.stft_mag(jnp.asarray(y), NFFT, HOP, WIN)))
    key, theta = _theta(mag.shape)
    length = len(y)
    j = jax.jit(lambda m, k: jdsp.griffin_lim(m, 4, HOP, WIN, 'hann', momentum,
                                              length, key=k))(jnp.asarray(mag), key)
    t = tdsp.griffin_lim(torch.from_numpy(mag), 4, HOP, WIN, 'hann', momentum,
                         length, theta=torch.tensor(theta))
    _close(t, j, 1e-4)


def test_inv_log_mag_same_phase():
    """Vocoder-template flavour (DC row dropped -> zero row, power 1.2,
    momentum 0.7); same 1e-4 of peak as above."""
    y = _signal()
    mag = np.asarray(jdsp.stft_mag(jnp.asarray(y), NFFT, HOP, WIN))[1:]
    log_mag = np.log(np.clip(mag, 1e-5, None)).astype(np.float32)
    key, theta = _theta((JA.n_freq, mag.shape[1]))
    length = HOP * mag.shape[1] - 1
    j = jax.jit(lambda m, k: jdsp.inv_log_mag(m, JA, length=length, key=k))(
        jnp.asarray(log_mag), key)
    t = tdsp.inv_log_mag(torch.from_numpy(log_mag), TA, length=length,
                         theta=torch.tensor(theta))
    _close(t, j, 1e-4)


def test_griffin_lim_generator_phase_is_seeded():
    mag = torch.rand(JA.n_freq, 12)
    a = tdsp.griffin_lim(mag, 2, HOP, WIN, generator=torch.Generator().manual_seed(5))
    b = tdsp.griffin_lim(mag, 2, HOP, WIN, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (HOP * 11,)


def test_companding_and_scales():
    rng = np.random.RandomState(2)
    spec = rng.uniform(-4, 4, (JA.n_freq - 1, 30)).astype(np.float32)
    j = jdsp.spec_to_natural_scale(jnp.asarray(spec), JA)
    t = tdsp.spec_to_natural_scale(torch.from_numpy(spec), TA)
    _close(t, j, 1e-6)
    t, j = tdsp.fix_zero_dc(t, TA), jdsp.fix_zero_dc(j, JA)
    _close(t, j, 1e-6)
    _close(tdsp.mag_to_mel(t, TA), jdsp.mag_to_mel(j, JA), 1e-6)
    x = rng.uniform(0, 3, (5, 7)).astype(np.float32)
    _close(tdsp.amp_to_db(torch.from_numpy(x)), jdsp.amp_to_db(jnp.asarray(x)), 1e-6)
    _close(tdsp.db_to_amp(torch.from_numpy(x)), jdsp.db_to_amp(jnp.asarray(x)), 1e-6)
    _close(tdsp.normalize_db(torch.from_numpy(x), TA),
           jdsp.normalize_db(jnp.asarray(x), JA), 1e-6)
    _close(tdsp.denormalize_db(torch.from_numpy(x), TA),
           jdsp.denormalize_db(jnp.asarray(x), JA), 1e-6)


def test_preemphasis_round_trip():
    """Pre-emphasis FIR and its IIR inverse (a log-depth scan here, an
    associative scan there): 1e-5 of peak over 6k samples."""
    y = _signal()
    _close(tdsp.preemphasis(torch.from_numpy(y)), jdsp.preemphasis(jnp.asarray(y)), 1e-6)
    _close(tdsp.inv_preemphasis(torch.from_numpy(y)),
           jax.jit(jdsp.inv_preemphasis)(jnp.asarray(y)), 1e-5)
    back = tdsp.inv_preemphasis(tdsp.preemphasis(torch.from_numpy(y)))
    _close(back, y, 1e-5)
