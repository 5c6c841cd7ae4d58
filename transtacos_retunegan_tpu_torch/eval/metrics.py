"""Objective quality metrics, ported from
``transtacos_retunegan_tpu/eval/metrics.py`` (the same numpy code):
multi-resolution spectral distance, mel-cepstral distortion, SNR, wideband
PESQ where the third-party ``pesq`` package is installed (None otherwise),
a first-party PESQ-shaped proxy, the prosody accuracy the acoustic trainer
logs, alignment diagnostics and the folder sweep ``evaluate_dirs``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy import signal as sps

from ..audio import features as F
from ..audio import transforms as T
from ..config import AudioConfig, Config


def align_lengths(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    return a[:n], b[:n]


def multi_stft_distance(y: np.ndarray, y_hat: np.ndarray, cfg: Config) -> float:
    """Same quantity the vocoder validates on (mean L1 of mel + log-mel over
    the configured resolutions)."""
    y, y_hat = align_lengths(y, y_hat)
    total = 0.0
    for n_fft, win, hop in cfg.vocoder.multi_stft_params:
        basis = T._mel_basis(cfg.audio, n_fft)
        s_r = np.abs(F.stft_np(y, n_fft, hop, win, cfg.audio.window_fn)) + 1e-9
        s_g = np.abs(F.stft_np(y_hat, n_fft, hop, win, cfg.audio.window_fn)) + 1e-9
        m_r, m_g = basis @ s_r, basis @ s_g
        total += np.mean(np.abs(m_r - m_g))
        total += np.mean(np.abs(np.log(np.maximum(m_r, 1e-12))
                                - np.log(np.maximum(m_g, 1e-12))))
    return float(total / len(cfg.vocoder.multi_stft_params))


def mel_cepstral_distortion(y: np.ndarray, y_hat: np.ndarray,
                            cfg: AudioConfig, n_mfcc: int = 13) -> float:
    """MCD (dB) over mel-cepstra via DCT of log-mel."""
    y, y_hat = align_lengths(y, y_hat)

    def mfcc(w):
        m = T.get_mel(w, cfg)                      # [M, T] log-mel
        from scipy.fftpack import dct
        return dct(m, axis=0, norm='ortho')[1:n_mfcc + 1]

    c_r, c_g = mfcc(y), mfcc(y_hat)
    t = min(c_r.shape[1], c_g.shape[1])
    diff = c_r[:, :t] - c_g[:, :t]
    return float((10.0 / np.log(10)) * np.sqrt(2.0)
                 * np.mean(np.sqrt(np.sum(diff ** 2, axis=0))))


def snr_db(y: np.ndarray, y_hat: np.ndarray) -> float:
    """Time-domain SNR -- PHASE-BLIND-HOSTILE by construction.

    A vocoder that re-synthesizes phase (any GAN vocoder; the reference's
    RetuneGAN too) produces waveforms whose samples do not align with the
    ground truth even when the audio is perceptually closer, so SNR can
    REGRESS while mstft/MCD/pesq improve (seen in
    ``docs/convergence_r4/quality_eval.json``: gan -1.87 dB vs GL -0.44 dB
    with every spectral metric better).  Report it for completeness, judge
    on the spectral metrics."""
    y, y_hat = align_lengths(y, y_hat)
    noise = y - y_hat
    return float(10 * np.log10((np.sum(y ** 2) + 1e-12)
                               / (np.sum(noise ** 2) + 1e-12)))


def pesq_wb(y: np.ndarray, y_hat: np.ndarray, sr: int) -> Optional[float]:
    """Wideband PESQ at 16 kHz (reference ``test_pesq.py:11-34``); None when
    the ``pesq`` package is unavailable."""
    try:
        from pesq import pesq  # type: ignore
    except ImportError:
        return None
    y, y_hat = align_lengths(y, y_hat)
    if sr != 16000:
        g = np.gcd(sr, 16000)
        y = sps.resample_poly(y, 16000 // g, sr // g)
        y_hat = sps.resample_poly(y_hat, 16000 // g, sr // g)
    return float(pesq(16000, y, y_hat, 'wb'))


def _bark_filterbank(sr: int, n_fft: int, n_bands: int = 24) -> np.ndarray:
    """Triangular filters equally spaced on the bark scale (Zwicker)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    bark = 13.0 * np.arctan(0.00076 * freqs) \
        + 3.5 * np.arctan((freqs / 7500.0) ** 2)
    edges = np.linspace(0.0, bark[-1], n_bands + 2)
    fb = np.zeros((n_bands, len(freqs)))
    for i in range(n_bands):
        lo, ce, hi = edges[i], edges[i + 1], edges[i + 2]
        up = (bark - lo) / max(ce - lo, 1e-9)
        down = (hi - bark) / max(hi - ce, 1e-9)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def pesq_proxy(y: np.ndarray, y_hat: np.ndarray, sr: int) -> float:
    """First-party PESQ-inspired quality proxy in [1.0, 4.5].

    Without the ``pesq`` package the reference's objective-quality
    capability (``retunegan/tools/test_pesq.py:17-34``) would report no
    number.  This follows P.862's shape -- 16 kHz, gain alignment,
    bark-band loudness (power^0.23), symmetric + asymmetric
    (additive-noise-weighted) disturbances mapped to a MOS-like scale --
    but is NOT ITU-calibrated: use it as a monotonic relative score, not an
    absolute PESQ value.  mstft and MCD are the primary metrics; this
    proxy is a secondary tie-breaker.
    """
    y, y_hat = align_lengths(np.asarray(y, np.float64),
                             np.asarray(y_hat, np.float64))
    if sr != 16000:
        g = np.gcd(sr, 16000)
        y = sps.resample_poly(y, 16000 // g, sr // g)
        y_hat = sps.resample_poly(y_hat, 16000 // g, sr // g)
    # gain alignment on overall active power
    p_ref = np.mean(y ** 2) + 1e-20
    y_hat = y_hat * np.sqrt(p_ref / (np.mean(y_hat ** 2) + 1e-20))

    n_fft, hop = 512, 256                     # 32 ms frames, 50% overlap
    win = np.hanning(n_fft)
    n = (len(y) - n_fft) // hop + 1
    if n < 2:
        # too short for framing (<~48 ms): sample-domain distance through
        # the SAME saturating MOS curve, keeping the scale continuous
        d = float(np.mean(np.abs(y_hat - y)) / (np.mean(np.abs(y)) + 1e-12))
        return float(np.clip(1.0 + 3.5 / (1.0 + d ** 1.5), 1.0, 4.5))
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    p_r = np.abs(np.fft.rfft(y[idx] * win, axis=1)) ** 2
    p_d = np.abs(np.fft.rfft(y_hat[idx] * win, axis=1)) ** 2
    fb = _bark_filterbank(16000, n_fft)
    l_r = (p_r @ fb.T + 1e-12) ** 0.23        # loudness-domain bands
    l_d = (p_d @ fb.T + 1e-12) ** 0.23
    # score only frames where the reference is active
    active = np.mean(l_r, axis=1) > 0.3 * np.mean(l_r)
    if not active.any():
        active = np.ones(n, bool)
    diff = l_d[active] - l_r[active]
    norm = np.mean(l_r[active]) + 1e-12
    d_sym = np.mean(np.abs(diff)) / norm
    d_asym = (np.mean(np.clip(diff, 0.0, None) ** 2) ** 0.5) / norm
    d = d_sym + 0.5 * d_asym
    # monotone saturating map: d=0 -> 4.5; d ~0.8 (20 dB SNR) -> ~3;
    # d ~2.3 (0 dB SNR) -> ~1.7; asymptote 1.0
    score = 1.0 + 3.5 / (1.0 + (d / 1.0) ** 1.5)
    return float(np.clip(score, 1.0, 4.5))


def prds_accuracy(prds_true: np.ndarray, prds_pred: np.ndarray,
                  text_lengths: np.ndarray) -> float:
    """Masked token accuracy of the prosody subnetwork's predictions.

    The reference's only prdsnet evaluation is the checkpoint-time
    ground-truth-vs-predicted dump (``transtacos/train.py:110-121``); this
    turns the same comparison into a number: fraction of VALID text
    positions (pos < text_length per row) where the predicted prosody mark
    equals the label.
    """
    prds_true = np.asarray(prds_true)
    prds_pred = np.asarray(prds_pred)
    lens = np.asarray(text_lengths)
    mask = np.arange(prds_true.shape[-1])[None, :] < lens[:, None]
    n = mask.sum()
    if n == 0:
        return 0.0
    return float(((prds_true == prds_pred) & mask).sum() / n)


def alignment_diagonality(align: np.ndarray,
                          mass_thresh: float = 0.25) -> Dict[str, float]:
    """Diagnostics for a decoder alignment matrix [n_text, n_decode_steps].

    * ``diagonality``: Pearson correlation between the decode-step index and
      the argmax text position -- ~1.0 for a clean monotone diagonal, ~0 for
      unfocused/static attention.
    * ``focus``: mean max attention weight per decode step.
    * ``coverage``: fraction of text positions that are the argmax of at
      least one decode step (diagonal alignments read every token).
    * ``mass_coverage``: fraction of text positions whose TOTAL attention
      mass across decode steps is >= ``mass_thresh`` (in units of decode
      steps).  Argmax coverage structurally under-counts at r=5: a phone
      spoken for fewer frames than one decode step covers (< r * hop =
      62.5 ms) can never win an argmax even under a perfect alignment,
      while its attention mass (~ duration / r steps) is still visible.
      The default 0.25 sits below the mass of the shortest real phones
      (~30 ms ~ 0.5 steps) but above off-diagonal leakage.
    """
    a = np.asarray(align, np.float64)
    n_text, n_steps = a.shape
    pos = np.argmax(a, axis=0)
    t = np.arange(n_steps)
    if n_steps >= 2 and np.std(pos) > 0:
        diag = float(np.corrcoef(t, pos)[0, 1])
    else:
        diag = 0.0
    return {
        'diagonality': diag,
        'focus': float(np.mean(np.max(a, axis=0))),
        'coverage': float(len(np.unique(pos)) / max(n_text, 1)),
        'mass_coverage': float((a.sum(axis=1) >= mass_thresh).sum()
                               / max(n_text, 1)),
    }


def evaluate_pair(y: np.ndarray, y_hat: np.ndarray, cfg: Config) -> Dict[str, float]:
    out = {
        'mstft': multi_stft_distance(y, y_hat, cfg),
        'mcd': mel_cepstral_distortion(y, y_hat, cfg.audio),
        'snr_db': snr_db(y, y_hat),
        'pesq_proxy': pesq_proxy(y, y_hat, cfg.audio.sample_rate),
    }
    p = pesq_wb(y, y_hat, cfg.audio.sample_rate)
    if p is not None:
        out['pesq_wb'] = p
    return out


def evaluate_dirs(ref_dir: str, gen_dir: str, cfg: Optional[Config] = None,
                  suffix: str = '.gen.wav') -> Dict[str, float]:
    """Score generated wavs against same-named references (the
    ``test_pesq.py`` folder-sweep capability)."""
    cfg = cfg or Config()
    agg: Dict[str, list] = {}
    for fn in sorted(os.listdir(ref_dir)):
        if not fn.endswith('.wav'):
            continue
        gen_fp = os.path.join(gen_dir, fn.replace('.wav', suffix))
        if not os.path.exists(gen_fp):
            gen_fp = os.path.join(gen_dir, fn)
            if not os.path.exists(gen_fp):
                continue
        y = F.load_wav(os.path.join(ref_dir, fn), cfg.audio)
        y_hat = F.load_wav(gen_fp, cfg.audio)
        for k, v in evaluate_pair(y, y_hat, cfg).items():
            agg.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}
