"""ctypes bindings for the native host DSP library (``native/ttsdsp.cpp``),
ported from ``transtacos_retunegan_tpu/data/native.py``.

The vocoder data pipeline's CPU hot spot is the per-utterance Griffin-Lim
template; ``native/ttsdsp.cpp`` computes it with a C++ radix-2 FFT under
the numpy path's conventions.  The library is built from that source in
place (``ops/build.py::load_host``: the host compiler, the flags of
``native/Makefile``) into the package's ``_build/`` at first use, so the
JAX package and the port run one source.  A failed build raises with the
compiler's output; there is no silent numpy fallback: the numpy path is
``audio.transforms.inv_log_mag(..., engine='numpy')``, taken only on
request.  A ``ctypes.CDLL`` call releases the interpreter lock, so the
loader's worker threads compute templates side by side.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import AudioConfig
from ..ops import build

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'ttsdsp.cpp'

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    'ttsdsp_stft_mag': [_F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _F32P],
    'ttsdsp_griffin_lim': [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_double,
                           ctypes.c_int64, ctypes.c_uint64, _F32P],
    'ttsdsp_rms': [_F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _F32P],
}


def lib() -> ctypes.CDLL:
    """The native library, built from ``native/ttsdsp.cpp`` if needed."""
    dll = build.load_host(SOURCE)
    if not hasattr(dll, 'ttsdsp_bound'):
        for fn, argtypes in _SIGNATURES.items():
            getattr(dll, fn).restype = ctypes.c_int
            getattr(dll, fn).argtypes = argtypes
        dll.ttsdsp_bound = True
    return dll


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _signal(y: np.ndarray) -> np.ndarray:
    y = np.ascontiguousarray(y, np.float32)
    if y.ndim != 1 or y.size == 0:
        raise ValueError(f'expected a non-empty 1-D signal, got shape {y.shape}')
    return y


def stft_mag(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """|STFT| as [F, T] float32 (centred frames, the numpy path's window)."""
    y = _signal(y)
    nf = 1 + len(y) // hop
    out = np.empty((nf, n_fft // 2 + 1), np.float32)
    got = lib().ttsdsp_stft_mag(_fptr(y), len(y), n_fft, hop, win, _fptr(out))
    if got != nf:
        raise RuntimeError(f'ttsdsp_stft_mag wrote {got} frames, expected {nf}')
    return out.T


def griffin_lim(mag: np.ndarray, n_iter: int, cfg: AudioConfig,
                momentum: float = 0.0, length: Optional[int] = None,
                seed: int = 114514) -> np.ndarray:
    """Magnitudes [F, T] (already power-raised) -> waveform float32 of
    ``length`` samples (``hop * (T - 1)`` by default); ``n_fft = 2 (F - 1)``."""
    if mag.ndim != 2 or mag.shape[0] < 2:
        raise ValueError(f'expected magnitudes [F, T], got shape {mag.shape}')
    half, nf = mag.shape
    if length is None:
        length = cfg.hop_length * (nf - 1)
    magc = np.ascontiguousarray(mag.T, np.float32)   # frame-major
    out = np.empty(length, np.float32)
    lib().ttsdsp_griffin_lim(_fptr(magc), nf, 2 * (half - 1), cfg.hop_length,
                             cfg.win_length, n_iter, momentum, length, seed,
                             _fptr(out))
    return out


def inv_log_mag(log_mag: np.ndarray, cfg: AudioConfig,
                length: Optional[int] = None) -> np.ndarray:
    """The vocoder's Griffin-Lim template from a log-magnitude [F or F-1, T]
    (``transforms.inv_log_mag``'s native engine): ``exp`` in float64, a zero
    DC row where it was dropped, ``gl_power``, ``gl_iters_vocoder``
    iterations at ``gl_momentum``, phases seeded by ``cfg.randseed`` for
    every utterance."""
    s = np.exp(log_mag.astype(np.float64))
    if s.shape[0] == cfg.n_freq - 1:
        s = np.concatenate([np.zeros([1, s.shape[1]]), s], axis=0)
    s = (s ** cfg.gl_power).astype(np.float32)
    return griffin_lim(s, cfg.gl_iters_vocoder, cfg, momentum=cfg.gl_momentum,
                       length=length, seed=cfg.randseed)


def rms(y: np.ndarray, frame: int, hop: int) -> np.ndarray:
    """Frame RMS (centred frames, reflect padding): ``len(y) // hop + 1``
    values."""
    y = _signal(y)
    out = np.empty(1 + len(y) // hop, np.float32)
    lib().ttsdsp_rms(_fptr(y), len(y), frame, hop, _fptr(out))
    return out
