"""STFT / iSTFT / Griffin-Lim / companding in PyTorch, ported from
``transtacos_retunegan_tpu/audio/dsp.py``.

The JAX package writes the (i)STFT as windowed-DFT matmuls because its
target had no FFT; here ``torch.stft`` and ``torch.fft.irfft`` do that work.
Conventions are unchanged: librosa/torch ``center=True`` with reflect
padding, ``n_frames = 1 + T // hop``, waveforms ``[..., T]`` and
spectrograms ``[..., F, n_frames]``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import mel as melmod
from ..config import AudioConfig

EPS_AMP = 1e-5


@functools.lru_cache(maxsize=16)
def _padded_window(kind: str, win_length: int, n_fft: int) -> np.ndarray:
    """Analysis window center-padded to n_fft (librosa pad_center)."""
    w = melmod.window(kind, win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _ola_norm(n_frames: int, n_fft: int, hop_length: int, win_length: int,
              window: str) -> np.ndarray:
    """Sum of squared windows over the overlap-add span, with the JAX
    package's guard: entries at or below 1e-11 become 1."""
    w2 = _padded_window(window, win_length, n_fft).astype(np.float64) ** 2
    acc = np.zeros(n_fft + hop_length * (n_frames - 1))
    for i in range(n_frames):
        acc[i * hop_length:i * hop_length + n_fft] += w2
    return np.where(acc > 1e-11, acc, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(device: torch.device, fn, *args) -> torch.Tensor:
    """``fn(*args)`` (a numpy constant) as a tensor on ``device``, built
    once: a copy from pageable host memory per call would wait for the
    card's queue."""
    return torch.from_numpy(fn(*args)).to(device)


def _window(kind: str, win_length: int, n_fft: int, like: torch.Tensor):
    return _on_device(like.device, _padded_window, kind, win_length, n_fft).to(like.dtype)


@functools.lru_cache(maxsize=32)
def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of ``y`` padded by ``pad`` on each side with numpy's
    'reflect' mode, which, unlike ``F.pad``, also takes ``pad >= n``."""
    period = 2 * (n - 1)
    i = np.abs(np.arange(-pad, n + pad)) % period
    return np.where(i >= n, period - i, i)


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         window: str = 'hann') -> torch.Tensor:
    """Complex STFT ``[..., T] -> [..., n_fft//2+1, n_frames]``."""
    lead = y.shape[:-1]
    idx = _on_device(y.device, _reflect_index, y.shape[-1], n_fft // 2)
    s = torch.stft(y.reshape(-1, y.shape[-1])[:, idx], n_fft, hop_length,
                   window=_window(window, win_length, n_fft, y),
                   center=False, return_complex=True)
    return s.reshape(lead + s.shape[-2:])


def stft_ri(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
            window: str = 'hann') -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT as a (real, imag) pair, each ``[..., F, n_frames]``."""
    s = stft(y, n_fft, hop_length, win_length, window)
    return s.real, s.imag


def istft(spec: torch.Tensor, hop_length: int, win_length: int,
          window: str = 'hann', length: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``stft``: synthesis window, overlap-add, division by the
    window-square envelope, centre trim.  Default length
    ``hop * (n_frames - 1)``."""
    n_fft = 2 * (spec.shape[-2] - 1)
    nf = spec.shape[-1]
    lead = spec.shape[:-2]
    frames = torch.fft.irfft(spec.reshape((-1,) + spec.shape[-2:]).transpose(1, 2),
                             n=n_fft)                              # [b, T, n_fft]
    frames = frames * _window(window, win_length, n_fft, frames)
    total = n_fft + hop_length * (nf - 1)
    out = F.fold(frames.transpose(1, 2), (1, total), (1, n_fft),
                 stride=(1, hop_length))[:, 0, 0]                  # [b, total]
    norm = _ola_norm(nf, n_fft, hop_length, win_length, window)
    out = out / torch.from_numpy(norm).to(out.device)
    if length is None:
        length = hop_length * (nf - 1)
    out = out[:, n_fft // 2:n_fft // 2 + length]
    return out.reshape(lead + out.shape[-1:])


def istft_ri(re: torch.Tensor, im: torch.Tensor, hop_length: int,
             win_length: int, window: str = 'hann',
             length: Optional[int] = None) -> torch.Tensor:
    return istft(torch.complex(re, im), hop_length, win_length, window, length)


Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def random_phase(shape, generator: Generators, device) -> torch.Tensor:
    """``2*pi*U[0, 1)`` of ``shape``.  ``generator`` is one
    ``torch.Generator`` (or None, the default one) for the whole tensor, or a
    sequence of them, one per row of the leading dimension: each row then
    draws exactly what it would draw alone, whatever batch it is in."""
    if generator is None or isinstance(generator, torch.Generator):
        return 2.0 * np.pi * torch.rand(shape, generator=generator, device=device)
    if len(generator) != shape[0]:
        raise ValueError(f'{len(generator)} generators for {shape[0]} rows')
    return torch.stack([2.0 * np.pi * torch.rand(shape[1:], generator=g, device=device)
                        for g in generator])


def griffin_lim(mag: torch.Tensor, n_iter: int, hop_length: int,
                win_length: int, window: str = 'hann', momentum: float = 0.0,
                length: Optional[int] = None,
                theta: Optional[torch.Tensor] = None,
                generator: Generators = None) -> torch.Tensor:
    """Phase reconstruction ``[..., F, n_frames] -> [..., T]``.

    The initial phase is ``theta`` (radians, the shape of ``mag``) when
    given, else drawn by ``random_phase`` from ``generator`` on mag's device
    (one per row of a batch ``[B, F, n_frames]``, as the JAX package's vmap
    over per-request keys).  ``momentum=0`` is the plain alternating
    projection; ``0.7`` is the fast flavour used for the vocoder template.
    """
    mag = mag.abs()
    n_fft = 2 * (mag.shape[-2] - 1)
    if theta is None:
        theta = random_phase(mag.shape, generator, mag.device)
    p = torch.polar(torch.ones_like(mag), theta.to(mag))
    alpha = momentum / (1.0 + momentum)
    t = torch.zeros_like(p)
    for _ in range(n_iter):
        y = istft(mag * p, hop_length, win_length, window, length)
        rebuilt = stft(y, n_fft, hop_length, win_length, window)
        u = rebuilt - alpha * t
        p = u / (u.abs() + 1e-16)
        t = rebuilt
    return istft(mag * p, hop_length, win_length, window, length)


def preemphasis(y: torch.Tensor, k: float = 0.97) -> torch.Tensor:
    """``y[i] - k * y[i-1]``."""
    return y - k * F.pad(y, (1, 0))[..., :-1]


def inv_preemphasis(y: torch.Tensor, k: float = 0.97) -> torch.Tensor:
    """IIR inverse ``o[i] = y[i] + k * o[i-1]`` as a log-depth
    (Hillis-Steele) scan: after the pass at offset 2^s every sample holds
    the sum of its last 2^(s+1) inputs weighted by powers of k."""
    out, p, off, n = y, k, 1, y.shape[-1]
    while off < n:
        out = out + p * F.pad(out, (off, 0))[..., :n]
        p, off = p * p, off * 2
    return out


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=EPS_AMP))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(s: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    return (2 * cfg.max_abs_value * ((s - cfg.min_level_db) / -cfg.min_level_db)
            - cfg.max_abs_value)


def denormalize_db(s: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    return (((s + cfg.max_abs_value) * -cfg.min_level_db) / (2 * cfg.max_abs_value)
            + cfg.min_level_db)


def spec_to_natural_scale(spec: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Normalised model scale -> raw |STFT| scale."""
    return db_to_amp(denormalize_db(spec, cfg) + cfg.ref_level_db)


def fix_zero_dc(s: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Re-prepend a near-zero DC row if it was dropped."""
    if s.shape[-2] == cfg.n_freq - 1:
        dc = s.amin(dim=(-2, -1), keepdim=True) * 1e-2
        dc = dc.expand(s.shape[:-2] + (1, s.shape[-1]))
        s = torch.cat([dc, s], dim=-2)
    return s


def _mel_basis_np(cfg: AudioConfig, n_fft: int) -> np.ndarray:
    return melmod.mel_basis(cfg.sample_rate, n_fft, cfg.n_mel, cfg.fmin,
                            cfg.fmax, htk=cfg.mel_scale == 'htk')


def mel_basis(cfg: AudioConfig, device, n_fft: Optional[int] = None) -> torch.Tensor:
    """``[n_mel, n_fft // 2 + 1]`` mel filters (at ``cfg.n_fft`` unless given)."""
    return _on_device(torch.device(device), _mel_basis_np, cfg, n_fft or cfg.n_fft)


def mag_to_mel(mag_natural: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Natural-scale |STFT| ``[..., F, T]`` -> natural-scale mel."""
    return torch.einsum('mf,...ft->...mt', mel_basis(cfg, mag_natural.device),
                        mag_natural)


def inv_log_mag(log_mag: torch.Tensor, cfg: AudioConfig,
                length: Optional[int] = None,
                theta: Optional[torch.Tensor] = None,
                generator: Generators = None) -> torch.Tensor:
    """log-magnitude ``[..., F, T]`` -> waveform through the fast
    Griffin-Lim (4 iterations, momentum 0.7): exp, a zero DC row if dropped,
    power law, length bound.  ``theta``/``generator`` as ``griffin_lim``."""
    s = torch.exp(log_mag)
    if s.shape[-2] == cfg.n_freq - 1:
        s = torch.cat([torch.zeros_like(s[..., :1, :]), s], dim=-2)
    return griffin_lim(s ** cfg.gl_power, cfg.gl_iters_vocoder, cfg.hop_length,
                       cfg.win_length, cfg.window_fn, momentum=cfg.gl_momentum,
                       length=length, theta=theta, generator=generator)


def inv_spec_acoustic(mag_natural: torch.Tensor, cfg: AudioConfig,
                      theta: Optional[torch.Tensor] = None,
                      generator: Generators = None) -> torch.Tensor:
    """natural |STFT| ``[..., F, T]`` -> waveform the acoustic service's way
    (the JAX ``Synthesizer._build_gl``): plain Griffin-Lim (``gl_iters_acoustic``
    iterations, momentum 0) on ``mag ** gl_power``, then inverse
    pre-emphasis.  ``theta``/``generator`` as ``griffin_lim``."""
    y = griffin_lim(mag_natural ** cfg.gl_power, cfg.gl_iters_acoustic,
                    cfg.hop_length, cfg.win_length, cfg.window_fn, momentum=0.0,
                    theta=theta, generator=generator)
    return inv_preemphasis(y, cfg.preemphasis)


@functools.lru_cache(maxsize=32)
def _imag_nonzero(n_freq: int, n_frames: int, last_symmetric: bool) -> np.ndarray:
    keep = np.ones((n_freq, n_frames), bool)
    keep[0, :] = keep[-1, :] = keep[:, 0] = False
    if last_symmetric:
        keep[:, -1] = False
    return keep


def _exact_zero_imag(im: torch.Tensor, num_samples: int, hop_length: int) -> torch.Tensor:
    """The imaginary part with the entries that are exactly zero for any
    real input set to +0: the DC and Nyquist rows, and every frame that
    reflect padding makes even-symmetric about its centre (the first; the
    last when it is centred on the last sample).  A DFT computes rounding
    noise of either sign there, which turns the phase of a bin with a
    negative real part into +pi or -pi at random."""
    keep = _on_device(im.device, _imag_nonzero, im.shape[-2], im.shape[-1],
                      (num_samples - 1) % hop_length == 0)
    return torch.where(keep, im, torch.zeros((), dtype=im.dtype, device=im.device))


def stft_mag_mel_phase(y: torch.Tensor, cfg: AudioConfig, n_fft: int,
                       win_length: int, hop_length: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable (|S|, mel, phase) of ``y [..., T]``, each ``[..., F or
    n_mel, n_frames]``, for the multi-STFT loss and the STFT discriminator:
    ``|S| = sqrt((re + 1e-9)^2 + im^2)`` (never exactly zero), the mel basis
    at this ``n_fft``, and ``atan2(im, re)`` on the raw ``re``.  Twice
    differentiable (the R1 penalty takes a gradient of a gradient through
    it)."""
    re, im = stft_ri(y, n_fft, hop_length, win_length, cfg.window_fn)
    im = _exact_zero_imag(im, y.shape[-1], hop_length)
    re_eps = re + 1e-9
    s = torch.sqrt(re_eps * re_eps + im * im)
    m = torch.einsum('mf,...ft->...mt', mel_basis(cfg, s.device, n_fft).to(s.dtype), s)
    return s, m, torch.atan2(im, re)
