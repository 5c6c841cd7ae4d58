"""Host-side waveform features in numpy, ported from
``transtacos_retunegan_tpu/audio/features.py``: centred framing, RMS energy
and silence trimming with ``librosa.effects.trim`` semantics."""

from __future__ import annotations

import numpy as np

from ..config import AudioConfig


def _frame(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal -> ``[n_frames, frame_length]`` (no padding)."""
    n = 1 + (len(y) - frame_length) // hop_length if len(y) >= frame_length else 0
    if n <= 0:
        return np.zeros((0, frame_length), dtype=y.dtype)
    strides = (y.strides[0] * hop_length, y.strides[0])
    return np.lib.stride_tricks.as_strided(y, (n, frame_length), strides).copy()


def _frame_centered(y: np.ndarray, frame_length: int, hop_length: int,
                    pad_mode: str = 'constant') -> np.ndarray:
    """Center-padded framing: ``n_frames = 1 + len(y)//hop``."""
    ypad = np.pad(y, frame_length // 2, mode=pad_mode)
    nf = 1 + len(y) // hop_length
    return _frame(ypad, frame_length, hop_length)[:nf]


def rms_energy(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """RMS per centered frame (librosa.feature.rms semantics) -> ``[T,]``."""
    frames = _frame_centered(y, frame_length, hop_length, 'reflect')
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=-1)).astype(np.float32)


def trim_silence(y: np.ndarray, cfg: AudioConfig, frame_length: int = 512,
                 hop_length: int = 128) -> np.ndarray:
    """Trim leading/trailing frames more than ``trim_below_peak_db`` below
    the peak (reference ``transtacos/audio.py:59-61``)."""
    power = rms_energy(y, frame_length, hop_length) ** 2
    ref = power.max()
    if ref <= 0:
        return y
    db = 10.0 * np.log10(np.maximum(power, 1e-10) / ref)
    keep = np.nonzero(db > -cfg.trim_below_peak_db)[0]
    if len(keep) == 0:
        return y[:0]
    start = int(keep[0]) * hop_length
    end = min(len(y), int(keep[-1] + 1) * hop_length)
    return y[start:end]
