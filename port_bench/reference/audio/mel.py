"""Mel scale + filterbank construction (first-party; no librosa in this image).

Implements the standard Slaney-style (Auditory Toolbox) and HTK mel scales and
the triangular filterbank with Slaney area normalization, matching what
``librosa.filters.mel`` produces for the reference
(``transtacos/audio.py:157-162``, ``retunegan/audio.py:20``).  Also builds the
regularized pseudo-inverse basis used by ``inv_mel``
(``transtacos/audio.py:164-175``).

Pure numpy; a copy of ``transtacos_retunegan_tpu/audio/mel.py`` so that the
port never imports the JAX package.  Callers convert to torch tensors.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale constants (Auditory Toolbox / librosa htk=False)
_F_SP = 200.0 / 3.0            # Hz per mel below the break
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size above the break


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region,
                 _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                 f)
    return f


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False) -> np.ndarray:
    """n_mels frequencies evenly spaced on the mel scale (inclusive ends)."""
    mmin, mmax = hz_to_mel(fmin, htk), hz_to_mel(fmax, htk)
    return mel_to_hz(np.linspace(mmin, mmax, n_mels), htk)


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)


@functools.lru_cache(maxsize=8)
def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
              htk: bool = False, norm: str = 'slaney') -> np.ndarray:
    """Triangular mel filterbank ``[n_mels, 1 + n_fft//2]`` (float32).

    Matches librosa's construction: triangles anchored at n_mels+2 mel-spaced
    frequencies, evaluated at FFT bin centers, optionally Slaney-normalized so
    each filter integrates to ~1 over Hz.
    """
    assert fmax < sr / 2 + 1e-9, 'fmax must be below Nyquist'
    fftfreqs = fft_frequencies(sr, n_fft)                          # [F]
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)           # [M+2]

    fdiff = np.diff(mel_f)                                         # [M+1]
    ramps = mel_f[:, None] - fftfreqs[None, :]                     # [M+2, F]

    lower = -ramps[:-2] / fdiff[:-1, None]                         # rising edge
    upper = ramps[2:] / fdiff[1:, None]                            # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))            # [M, F]

    if norm == 'slaney':
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]

    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_pseudo_inverse(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                       htk: bool = False) -> np.ndarray:
    """Regularized pseudo-inverse ``[1 + n_fft//2, n_mels]`` of the mel basis.

    Mirrors the reference's construction (``transtacos/audio.py:167-175``):
    ``m_T @ diag(1 / colsum(m @ m_T))`` with tiny-sum columns passed through.
    """
    m = mel_basis(sr, n_fft, n_mels, fmin, fmax, htk).astype(np.float64)
    p = m @ m.T                                                     # [M, M]
    s = p.sum(axis=0)
    d = np.where(np.abs(s) > 1e-8, 1.0 / np.where(np.abs(s) > 1e-8, s, 1.0), s)
    return (m.T @ np.diag(d)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def window(kind: str, win_length: int) -> np.ndarray:
    """Periodic analysis window, float32 (matches torch.*_window / librosa)."""
    n = np.arange(win_length, dtype=np.float64)
    if kind == 'hann':
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)
    elif kind == 'hamming':
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / win_length)
    elif kind == 'blackman':
        a0, a1, a2 = 0.42, 0.5, 0.08
        w = a0 - a1 * np.cos(2 * np.pi * n / win_length) + a2 * np.cos(4 * np.pi * n / win_length)
    elif kind == 'bartlett':
        w = 1.0 - np.abs((n - win_length / 2) / (win_length / 2))
    elif kind == 'rect':
        w = np.ones(win_length)
    else:
        raise ValueError(f'unknown window {kind!r}')
    return w.astype(np.float32)
