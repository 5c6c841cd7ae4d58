"""Host-side (numpy/scipy) waveform features and wav IO, ported from
``transtacos_retunegan_tpu/audio/features.py`` (the same code, so the
vocoder dataset's items are bit-identical to the JAX package's): wav
load/save and alignment, a numpy STFT, centred framing, RMS energy,
zero-crossing rate and the u/v mask, silence trimming with
``librosa.effects.trim`` semantics, YIN pitch tracking and the f0/c0
quantization of the acoustic model's training data, and the pitch / tempo
/ gain and SpecAugment-style augmentations of the vocoder's training
data."""

from __future__ import annotations

import numpy as np
from scipy import signal as sps
from scipy.io import wavfile

from . import mel as melmod
from ..config import AudioConfig


def load_wav(path: str, cfg: AudioConfig) -> np.ndarray:
    """Load mono float32 in (-1, 1), resampled to ``cfg.sample_rate``."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sr != cfg.sample_rate:
        g = np.gcd(int(sr), int(cfg.sample_rate))
        y = sps.resample_poly(y, cfg.sample_rate // g, sr // g).astype(np.float32)
    return y.astype(np.float32)


def save_wav(wav: np.ndarray, path: str, cfg: AudioConfig) -> None:
    """Write wav; optional loudness/compand/bandpass postprocess
    (reference ``transtacos/audio.py:33-49``)."""
    wav = np.asarray(wav, dtype=np.float32)
    if cfg.postprocess:
        wav = wav / max(1e-8, np.abs(wav).max()) * 0.999
        f1 = 0.5 * 32767 / max(0.01, np.max(np.abs(wav)))
        f2 = np.sign(wav) * np.power(np.abs(wav), 0.667)
        wav = f1 * f2
        fir = sps.firwin(cfg.n_freq, [cfg.fmin, cfg.fmax], pass_zero=False,
                         fs=cfg.sample_rate)
        wav = sps.convolve(wav, fir)
        wavfile.write(path, cfg.sample_rate, wav.astype(np.int16))
    else:
        wavfile.write(path, cfg.sample_rate, wav.astype(np.float32))


def align_wav(wav: np.ndarray, r: int) -> np.ndarray:
    """Zero-pad so ``len(wav) % r == 0`` (``transtacos/audio.py:52-56``)."""
    d = len(wav) % r
    if d != 0:
        wav = np.pad(wav, (0, r - d))
    return wav


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


def stft_np(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
            window: str = 'hann') -> np.ndarray:
    """numpy STFT with the same conventions as ``dsp.stft`` -> ``[F, T]``."""
    w = melmod.window(window, win_length)
    lpad = (n_fft - win_length) // 2
    w = np.pad(w, (lpad, n_fft - win_length - lpad))
    frames = _frame_centered(y.astype(np.float64), n_fft, hop_length, 'reflect')
    return np.fft.rfft(frames * w, axis=-1).T


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


def get_c0(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Reference ``transtacos/audio.py:112-114``."""
    return rms_energy(y, cfg.win_length, cfg.hop_length)


def zero_crossing_rate(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """ZCR per centered frame (librosa semantics: edge padding) -> ``[T,]``."""
    frames = _frame_centered(y, frame_length, hop_length, 'edge')
    sb = np.signbit(frames)
    crossings = np.abs(np.diff(sb, axis=-1))
    return np.mean(crossings, axis=-1).astype(np.float32)


def get_zcr(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    return zero_crossing_rate(y, cfg.win_length, cfg.hop_length)


def get_uv(zcr: np.ndarray, dyn: np.ndarray) -> np.ndarray:
    """Hand-tuned unvoiced mask (reference ``retunegan/audio.py:108-113``)."""
    return ((zcr > 0.18) | (dyn < 0.03)).astype(np.float32)


# ---------------------------------------------------------------------------
# YIN pitch tracking (first-party; librosa.yin semantics)
# ---------------------------------------------------------------------------

def yin(y: np.ndarray, fmin: float, fmax: float, sr: int, frame_length: int,
        hop_length: int, trough_threshold: float = 0.1) -> np.ndarray:
    """Fundamental-frequency track via YIN (de Cheveigné & Kawahara 2002).

    Matches librosa.yin's formulation: half-window difference function via FFT
    autocorrelation, cumulative-mean normalization, first trough below the
    threshold with parabolic interpolation, global min fallback.
    Returns ``[n_frames,]`` Hz with ``n_frames = 1 + len(y)//hop``.
    Reference usage: ``transtacos/audio.py:107-109``.
    """
    win_length = frame_length // 2
    min_period = max(int(np.ceil(sr / fmax)), 1)
    max_period = min(int(np.floor(sr / fmin)), frame_length - win_length - 1)

    frames = _frame_centered(y.astype(np.float64), frame_length, hop_length,
                             'constant')                      # [T, frame]
    # difference function d[tau] = e0 + e[tau] - 2*acf[tau], window W=win_length
    a = np.fft.rfft(frames, frame_length, axis=-1)
    b = np.fft.rfft(frames[..., win_length::-1], frame_length, axis=-1)
    acf = np.fft.irfft(a * b, frame_length, axis=-1)[..., win_length:]
    acf[np.abs(acf) < 1e-6] = 0.0

    energy = np.cumsum(frames ** 2, axis=-1)
    energy = energy[..., win_length:] - energy[..., :-win_length]
    energy[np.abs(energy) < 1e-6] = 0.0

    d = energy[..., :1] + energy - 2 * acf                    # [T, lags]

    # cumulative-mean-normalized difference over tau = 1..max_period
    tau = np.arange(1, max_period + 1)
    cmean = np.cumsum(d[..., 1:max_period + 1], axis=-1) / tau
    cmndf = d[..., min_period:max_period + 1] / (cmean[..., min_period - 1:] + 1e-30)

    # parabolic interpolation shifts around each lag
    shifts = np.zeros_like(cmndf)
    if cmndf.shape[-1] >= 3:
        denom = cmndf[..., :-2] - 2 * cmndf[..., 1:-1] + cmndf[..., 2:]
        numer = cmndf[..., :-2] - cmndf[..., 2:]
        with np.errstate(divide='ignore', invalid='ignore'):
            sh = np.where(np.abs(denom) > 1e-12, numer / (2 * denom), 0.0)
        shifts[..., 1:-1] = np.clip(sh, -0.5, 0.5)

    # first local trough below threshold; fall back to global min
    is_trough = np.zeros(cmndf.shape, dtype=bool)
    if cmndf.shape[-1] >= 2:
        interior = ((cmndf[..., 1:-1] <= cmndf[..., :-2]) &
                    (cmndf[..., 1:-1] <= cmndf[..., 2:]))
        is_trough[..., 1:-1] = interior
        is_trough[..., 0] = cmndf[..., 0] < cmndf[..., 1]
    below = is_trough & (cmndf < trough_threshold)
    has = below.any(axis=-1)
    first = np.argmax(below, axis=-1)
    gmin = np.argmin(cmndf, axis=-1)
    pick = np.where(has, first, gmin)

    rows = np.arange(cmndf.shape[0])
    period = min_period + pick + shifts[rows, pick]
    return (sr / np.maximum(period, 1e-6)).astype(np.float32)


def get_f0(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    return yin(y, cfg.rf0min_hz, cfg.rf0max_hz, cfg.sample_rate,
               cfg.win_length, cfg.hop_length)


# ---------------------------------------------------------------------------
# f0/c0 quantization (reference ``transtacos/audio.py:117-127``)
# ---------------------------------------------------------------------------

def hz_to_midi(f):
    return 12.0 * (np.log2(np.maximum(np.asarray(f, np.float64), 1e-12)) - np.log2(440.0)) + 69.0


def quantize_f0(f0: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    q = hz_to_midi(f0) - cfg.n_f0_min
    return np.clip(q, 0, cfg.n_f0_bins - 1).astype(np.int32)


def quantize_c0(c0: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    q = (c0 - cfg.c0min) / (cfg.c0max - cfg.c0min) * cfg.n_c0_bins
    return np.clip(q, 0, cfg.n_c0_bins - 1).astype(np.int32)


def _istft_np(spec: np.ndarray, hop_length: int, win_length: int,
              window: str, length: int) -> np.ndarray:
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
    out = out[pad:pad + length]
    if len(out) < length:
        out = np.pad(out, (0, length - len(out)))
    return out


def phase_vocoder(spec: np.ndarray, rate: float, hop_length: int) -> np.ndarray:
    """Standard phase-vocoder time stretch on a complex STFT ``[F, T]``."""
    n_fft = 2 * (spec.shape[0] - 1)
    time_steps = np.arange(0, spec.shape[1], rate)
    phi_advance = np.linspace(0, np.pi * hop_length, spec.shape[0])
    out = np.zeros((spec.shape[0], len(time_steps)), dtype=np.complex128)
    phase_acc = np.angle(spec[:, 0])
    spec_pad = np.pad(spec, [(0, 0), (0, 2)])
    for t, step in enumerate(time_steps):
        i = int(step)
        frac = step - i
        cols = spec_pad[:, i:i + 2]
        mag = (1 - frac) * np.abs(cols[:, 0]) + frac * np.abs(cols[:, 1])
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(cols[:, 1]) - np.angle(cols[:, 0]) - phi_advance
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phi_advance + dphase
    return out


def time_stretch(y: np.ndarray, rate: float, cfg: AudioConfig) -> np.ndarray:
    d = stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window_fn)
    ds = phase_vocoder(d, rate, cfg.hop_length)
    return _istft_np(ds, cfg.hop_length, cfg.win_length, cfg.window_fn,
                     int(round(len(y) / rate))).astype(np.float32)


def pitch_shift(y: np.ndarray, semitones: float, cfg: AudioConfig) -> np.ndarray:
    """Pitch shift = time-stretch then resample back to the original length."""
    from fractions import Fraction
    rate = 2.0 ** (-semitones / 12.0)
    stretched = time_stretch(y, rate, cfg)
    n_out = len(y)
    # bound the polyphase factor so coprime lengths don't build giant filters
    frac = Fraction(n_out, max(1, len(stretched))).limit_denominator(1000)
    shifted = sps.resample_poly(stretched, frac.numerator, frac.denominator)
    if len(shifted) < n_out:
        shifted = np.pad(shifted, (0, n_out - len(shifted)))
    return shifted[:n_out].astype(np.float32)


def augment_wav(y: np.ndarray, cfg: AudioConfig, rng: np.random.RandomState,
                do_pitch_shift: bool = True, do_time_stretch: bool = True,
                do_dynamic_scale: bool = True) -> np.ndarray:
    """Prob-gated pitch / tempo / gain augmentation
    (reference ``retunegan/audio.py:45-69``)."""
    if do_pitch_shift and rng.random() > 0.75:
        semitone = max(min(round(rng.normal(scale=12 / 3)), 12), -12)
        if semitone != 0:
            y = pitch_shift(y, semitone, cfg)
    if do_time_stretch and rng.random() > 0.90:
        alpha = 2 ** rng.normal(scale=1 / 5)
        if abs(alpha - 1.0) < 0.1:
            alpha = 1.0
        if alpha != 1.0:
            y = time_stretch(y, alpha, cfg)
    if do_dynamic_scale and rng.random() > 0.25:
        alpha = 2 ** rng.normal(scale=1 / 3)
        y = y * alpha
        absmax = max(y.max(), -y.min())
        if absmax > 1.0:
            y = y / absmax
    return y.astype(np.float32)


def augment_spec(s: np.ndarray, rng: np.random.RandomState, prob: float = 0.2,
                 rounds: int = 3, freq_width: int = 9, time_width: int = 3,
                 time_mask: bool = True, freq_mask: bool = True) -> np.ndarray:
    """SpecAugment-style masks + global 3x3 mean blur
    (reference ``retunegan/audio.py:72-95``)."""
    s = s.copy()
    f, t = s.shape
    for _ in range(rounds):
        if freq_mask and rng.random() < prob:
            st = rng.randint(0, f - freq_width)
            r = rng.randint(1, freq_width)
            s[st:st + r, :] = rng.uniform(low=s.min(), high=s.mean())
        if time_mask and rng.random() < prob:
            st = rng.randint(0, t - time_width)
            r = rng.randint(1, time_width)
            s[:, st:st + r] = rng.uniform(low=s.min(), high=s.mean())
    # 3x3 average blur, stride 1, zero-count-correct edges (AvgPool2d pad=1
    # counts the padded zeros, so plain 'same' convolution matches torch)
    kernel = np.ones((3, 3)) / 9.0
    s = sps.convolve2d(s, kernel, mode='same', boundary='fill')
    return s.astype(np.float32)
