"""Host-side (numpy) composite transforms, ported from
``transtacos_retunegan_tpu/audio/transforms.py`` (the same code): linear
and mel spectrograms, the natural-scale conversions, numpy Griffin-Lim and
the vocoder's Griffin-Lim template (``inv_log_mag``), which runs on the
native C++ library (``data/native.py``) unless the caller asks for the
numpy engine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import signal as sps

from . import mel as melmod
from .features import stft_np
from ..config import AudioConfig
from ..data import native

ENGINES = ('native', 'numpy')

EPS_AMP = 1e-5


def _mel_basis(cfg: AudioConfig, n_fft: Optional[int] = None) -> np.ndarray:
    return melmod.mel_basis(cfg.sample_rate, n_fft or cfg.n_fft, cfg.n_mel,
                            cfg.fmin, cfg.fmax, htk=cfg.mel_scale == 'htk')


def amp_to_db(x):
    return 20.0 * np.log10(np.maximum(EPS_AMP, x))


def db_to_amp(x):
    return np.power(10.0, x * 0.05)


def normalize_db(s, cfg: AudioConfig):
    return 2 * cfg.max_abs_value * ((s - cfg.min_level_db) / -cfg.min_level_db) - cfg.max_abs_value


def denormalize_db(s, cfg: AudioConfig):
    return ((s + cfg.max_abs_value) * -cfg.min_level_db) / (2 * cfg.max_abs_value) + cfg.min_level_db


def preemphasis(y: np.ndarray, k: float) -> np.ndarray:
    return sps.lfilter([1, -k], [1], y)


def inv_preemphasis(y: np.ndarray, k: float) -> np.ndarray:
    return sps.lfilter([1], [1, -k], y)


def get_specs(y: np.ndarray, cfg: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Waveform -> (normalized linear [F,T], normalized mel [M,T]) float32."""
    d = np.abs(stft_np(preemphasis(y, cfg.preemphasis), cfg.n_fft,
                       cfg.hop_length, cfg.win_length, cfg.window_fn))
    s = amp_to_db(d) - cfg.ref_level_db
    m = amp_to_db(_mel_basis(cfg) @ d) - cfg.ref_level_db
    return (normalize_db(s, cfg).astype(np.float32),
            normalize_db(m, cfg).astype(np.float32))


def spec_to_natural_scale(spec: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    return db_to_amp(denormalize_db(spec, cfg) + cfg.ref_level_db)


def fix_zero_dc(s: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    if s.shape[0] == cfg.n_freq - 1:
        s = np.concatenate([np.ones([1, s.shape[1]]) * s.min() * 1e-2, s], axis=0)
    return s


def _istft_np(spec: np.ndarray, hop_length: int, win_length: int, window: str,
              length: Optional[int] = None) -> np.ndarray:
    n_fft = 2 * (spec.shape[0] - 1)
    w = melmod.window(window, win_length).astype(np.float64)
    lpad = (n_fft - win_length) // 2
    w = np.pad(w, (lpad, n_fft - win_length - lpad))
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * w
    nf = frames.shape[0]
    total = n_fft + hop_length * (nf - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    for i in range(nf):
        out[i * hop_length:i * hop_length + n_fft] += frames[i]
        norm[i * hop_length:i * hop_length + n_fft] += w ** 2
    out = out / np.where(norm > 1e-11, norm, 1.0)
    pad = n_fft // 2
    out = out[pad:]
    if length is None:
        length = hop_length * (nf - 1)
    if len(out) < length:
        out = np.pad(out, (0, length - len(out)))
    return out[:length]


def griffin_lim(mag: np.ndarray, n_iter: int, cfg: AudioConfig,
                momentum: float = 0.0, length: Optional[int] = None,
                seed: Optional[int] = None) -> np.ndarray:
    """numpy Griffin-Lim, both flavors (see ``dsp.griffin_lim``)."""
    rng = np.random.RandomState(cfg.randseed if seed is None else seed)
    angles = np.exp(2j * np.pi * rng.rand(*mag.shape))
    mag = np.abs(mag).astype(np.complex128)
    alpha = momentum / (1.0 + momentum)
    rebuilt = np.zeros_like(mag)
    for _ in range(n_iter):
        tprev = rebuilt
        y = _istft_np(mag * angles, cfg.hop_length, cfg.win_length,
                      cfg.window_fn, length)
        rebuilt = stft_np(y, 2 * (mag.shape[0] - 1), cfg.hop_length,
                          cfg.win_length, cfg.window_fn)
        upd = rebuilt - alpha * tprev
        angles = upd / (np.abs(upd) + 1e-16)
    return _istft_np(mag * angles, cfg.hop_length, cfg.win_length,
                     cfg.window_fn, length).astype(np.float32)


def inv_spec(spec: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Normalized linear spec [F,T] -> waveform (acoustic GL path)."""
    s = spec_to_natural_scale(spec, cfg)
    s = fix_zero_dc(s, cfg)
    y = griffin_lim(s ** cfg.gl_power, cfg.gl_iters_acoustic, cfg)
    return inv_preemphasis(y, cfg.preemphasis).astype(np.float32)


def get_mag(y: np.ndarray, cfg: AudioConfig, clamp_low: bool = True) -> np.ndarray:
    s = np.abs(stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window_fn))
    return np.log(s.clip(min=EPS_AMP) if clamp_low else s).astype(np.float32)


def mag_to_mel(mag_natural: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    return (_mel_basis(cfg) @ mag_natural).astype(np.float32)


def get_mel(y: np.ndarray, cfg: AudioConfig, clamp_low: bool = True) -> np.ndarray:
    s = np.abs(stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window_fn))
    m = _mel_basis(cfg) @ s
    return np.log(m.clip(min=EPS_AMP) if clamp_low else m).astype(np.float32)


def inv_log_mag(log_mag: np.ndarray, cfg: AudioConfig,
                length: Optional[int] = None, engine: str = 'native') -> np.ndarray:
    """log-magnitude [F or F-1, T] -> waveform via fast momentum GL
    (the vocoder's Griffin-Lim reference template).  ``engine``: 'native'
    (``data/native.py``, built at first use; a failed build raises) or
    'numpy'.  The two draw their initial phases from different generators,
    so their templates differ sample by sample."""
    if engine == 'native':
        y = native.inv_log_mag(log_mag, cfg, length=length)
    elif engine == 'numpy':
        s = np.exp(log_mag)
        if s.shape[0] == cfg.n_freq - 1:
            s = np.concatenate([np.zeros([1, s.shape[1]]), s], axis=0)
        y = griffin_lim(s ** cfg.gl_power, cfg.gl_iters_vocoder, cfg,
                        momentum=cfg.gl_momentum, length=length)
    else:
        raise ValueError(f'engine {engine!r} not in {ENGINES}')
    if length and len(y) != length:
        raise ValueError(f'template of {len(y)} samples, expected {length}')
    return y
