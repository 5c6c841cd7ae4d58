"""DSP design studies as runnable analyses.

Port of ``transtacos_retunegan_tpu/tools/dsp_studies.py``: the same host
numpy studies, on the port's own copies of ``audio/features``,
``audio/transforms`` and ``audio/mel`` (no device: it takes no
``--device``).  A capability rebuild of ``retunegan/tools/`` -- the
experiments that justified the reference's design constants (envelope pool
k=160, AvgPool MSD downsampler, 4-iter momentum Griffin-Lim,
phase-vs-magnitude recoverability, iSTFT iteration error).  Each study
returns structured numbers instead of showing plots.

Usage:
  python -m transtacos_retunegan_tpu_torch.tools.dsp_studies [--wav path.wav]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

from ..audio import features as F
from ..audio import transforms as T
from ..config import AudioConfig


def _test_signal(cfg: AudioConfig, seconds: float = 2.0) -> np.ndarray:
    t = np.arange(int(cfg.sample_rate * seconds)) / cfg.sample_rate
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t))
    y = env * (0.5 * np.sin(2 * np.pi * 220 * t)
               + 0.25 * np.sin(2 * np.pi * 440 * t)
               + 0.12 * np.sin(2 * np.pi * 881 * t))
    return y.astype(np.float32)


def study_griffinlim(cfg: AudioConfig, y: np.ndarray) -> Dict:
    """Spectral convergence vs iteration count / momentum
    (reference ``test_griffinlim.py``)."""
    y = F.align_wav(y, cfg.hop_length)[:-1]
    mag = np.abs(F.stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length,
                           cfg.window_fn))

    def spec_err(rec):
        m2 = np.abs(F.stft_np(rec, cfg.n_fft, cfg.hop_length, cfg.win_length,
                              cfg.window_fn))
        t = min(m2.shape[1], mag.shape[1])
        return float(np.mean(np.abs(mag[:, :t] - m2[:, :t])) / (np.mean(mag) + 1e-9))

    out = {}
    for n_iter, momentum in [(4, 0.0), (4, 0.7), (30, 0.0), (30, 0.99)]:
        rec = T.griffin_lim(mag, n_iter, cfg, momentum=momentum)
        out[f'iters={n_iter},momentum={momentum}'] = spec_err(rec)
    return out


def study_phase_recovery(cfg: AudioConfig, y: np.ndarray) -> Dict:
    """Magnitude-only vs phase-only reconstruction error
    (reference ``test_phase_recover.py``)."""
    y = F.align_wav(y, cfg.hop_length)[:-1]
    d = F.stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window_fn)
    mag, phase = np.abs(d), np.angle(d)

    perfect = T._istft_np(mag * np.exp(1j * phase), cfg.hop_length,
                          cfg.win_length, cfg.window_fn, len(y))
    mag_only = T.griffin_lim(mag, cfg.gl_iters_vocoder, cfg,
                             momentum=cfg.gl_momentum, length=len(y))
    unit_phase = T._istft_np(np.exp(1j * phase), cfg.hop_length,
                             cfg.win_length, cfg.window_fn, len(y))

    def err(rec):
        n = min(len(rec), len(y))
        return float(np.mean(np.abs(rec[:n] - y[:n])) / (np.mean(np.abs(y)) + 1e-9))

    return {'istft_roundtrip': err(perfect), 'mag_only_gl': err(mag_only),
            'phase_only_unit_mag': err(unit_phase)}


def study_envelope_pool(cfg: AudioConfig, y: np.ndarray,
                        ks: List[int] = (40, 80, 160, 320, 640)) -> Dict:
    """Envelope pool-size sweep (reference ``test_envolope.py`` -> k=160)."""
    out = {}
    for k in ks:
        n = len(y) // k * k
        pooled = y[:n].reshape(-1, k).max(axis=1)
        rel_var = float(np.std(np.diff(pooled)) / (np.std(y) + 1e-9))
        out[f'k={k}'] = {'n_segments': int(n // k),
                         'envelope_smoothness': rel_var}
    return out


def study_downsample(cfg: AudioConfig, y: np.ndarray) -> Dict:
    """AvgPool vs decimation for the MSD input pyramid
    (reference ``test_downsample.py``: AvgPool erases HF detail gradually)."""
    from scipy import signal as sps
    n = len(y) // 4 * 4

    def hf_energy(w):
        spec = np.abs(np.fft.rfft(w))
        return float(spec[len(spec) // 2:].sum() / (spec.sum() + 1e-9))

    avg = np.convolve(y[:n], np.ones(4) / 4, mode='same')[::2]
    dec = sps.resample_poly(y[:n], 1, 2)
    return {'orig_hf_ratio': hf_energy(y[:n]),
            'avgpool_hf_ratio': hf_energy(avg),
            'resample_hf_ratio': hf_energy(dec)}


def study_istft_iteration(cfg: AudioConfig, y: np.ndarray,
                          n_iter: int = 50) -> Dict:
    """Error accumulation under repeated stft->istft
    (reference ``test_istft_iter.py``)."""
    y = F.align_wav(y, cfg.hop_length)[:-1]
    cur = y.astype(np.float64)
    errs = []
    for i in range(n_iter):
        d = F.stft_np(cur, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window_fn)
        cur = T._istft_np(d, cfg.hop_length, cfg.win_length, cfg.window_fn, len(y))
        if i in (0, 9, n_iter - 1):
            errs.append((i + 1, float(np.max(np.abs(cur - y)))))
    return {f'iter_{i}': e for i, e in errs}


def study_strip_mirror(cfg: AudioConfig, y: np.ndarray) -> Dict:
    """Even/odd stripe statistics (reference ``test_strip_mirror.py``)."""
    n = len(y) // 2 * 2
    even, odd = y[:n:2], y[1:n:2]
    return {'mean_abs_diff': float(np.mean(np.abs(even - odd))),
            'corr': float(np.corrcoef(even, odd)[0, 1])}


def study_spec2wavset(cfg: AudioConfig, y: np.ndarray,
                      fft_params: List = ((2048, 1024, 256),
                                          (1024, 512, 128),
                                          (512, 256, 64))) -> Dict:
    """Sinusoid-wavset templates (reference ``tools/spec2wavset.py:5-16``).

    The design study behind the RefineGAN template idea: the STFT decomposes
    the signal into equally-spaced sinusoids, so summing the per-frame
    spectral-peak sinusoids yields a *clean* waveform template to add noise
    onto (cleaner than a Griffin-Lim output, which must be de-noised).
    Multiple STFT resolutions limit frequency loss and window leakage.

    Per resolution: pick per-frame magnitude peaks (threshold 2x mean, the
    reference's slope-walk peak picker, vectorized), synthesize the template
    as a literal sinusoid bank -- one continuous sinusoid per ever-peak bin
    at its center frequency, amplitude-enveloped by that bin's peak-masked
    magnitude track (the reference's ``A = 2*mag/sum(win)`` convention) --
    and report reconstruction error vs the original plus how few bins carry
    the signal.  A final row measures the multi-resolution averaged template.
    """
    y = F.align_wav(y, cfg.hop_length)[:-1].astype(np.float64)

    def peak_mask(mag: np.ndarray) -> np.ndarray:
        """Local maxima over frequency above the 2x-mean threshold
        (equivalent to the reference's up-slope/down-slope walk)."""
        up = np.zeros_like(mag, bool)
        up[1:-1] = (mag[1:-1] >= mag[:-2]) & (mag[1:-1] > mag[2:])
        return up & (mag > 2.0 * mag.mean())

    def wavset_template(n_fft: int, win: int, hop: int) -> tuple:
        mag = np.abs(F.stft_np(y, n_fft, hop, win, cfg.window_fn))
        mask = peak_mask(mag)
        masked = mag * mask
        n_frames = mag.shape[1]
        sr = cfg.sample_rate
        from ..audio.mel import window as make_window
        win_sum = float(np.sum(make_window(cfg.window_fn, win)))
        t = np.arange(len(y)) / sr
        centers = np.arange(n_frames) * hop / sr
        tmpl = np.zeros(len(y))
        for k in np.where(mask.any(axis=1))[0]:
            env = np.interp(t, centers, masked[k]) * (2.0 / win_sum)
            tmpl += env * np.sin(2.0 * np.pi * (k * sr / n_fft) * t)
        return tmpl, float(mask.mean()), mag

    def errors(tmpl: np.ndarray, mag_ref: np.ndarray, n_fft, win, hop) -> Dict:
        # no scale fit: the 2*mag/sum(win) amplitude convention is already
        # calibrated (exact-bin sinusoids reconstruct to ~4% error).  For
        # off-bin content the waveform decorrelates (phase drift) while the
        # spectrum stays close -- exactly the property the study measures
        # (templates are spectrally faithful, not sample-aligned).
        m2 = np.abs(F.stft_np(tmpl, n_fft, hop, win, cfg.window_fn))
        tt = min(m2.shape[1], mag_ref.shape[1])
        sc = float(np.linalg.norm(mag_ref[:, :tt] - m2[:, :tt])
                   / (np.linalg.norm(mag_ref[:, :tt]) + 1e-12))
        l1 = float(np.mean(np.abs(tmpl - y)) / (np.mean(np.abs(y)) + 1e-12))
        return {'spectral_convergence': sc, 'wav_rel_l1': l1}

    out = {}
    templates = []
    for n_fft, win, hop in fft_params:
        tmpl, frac, mag_ref = wavset_template(n_fft, win, hop)
        templates.append(tmpl)
        e = errors(tmpl, mag_ref, n_fft, win, hop)
        e['peak_bin_fraction'] = frac
        out[f'n_fft={n_fft}'] = e

    avg = np.mean(np.stack(templates), axis=0)
    n_fft, win, hop = fft_params[0]
    mag_ref = np.abs(F.stft_np(y, n_fft, hop, win, cfg.window_fn))
    out['multi_resolution_avg'] = errors(avg, mag_ref, n_fft, win, hop)
    return out


def run_all(cfg: AudioConfig, y: np.ndarray) -> Dict:
    return {
        'griffinlim': study_griffinlim(cfg, y),
        'phase_recovery': study_phase_recovery(cfg, y),
        'envelope_pool': study_envelope_pool(cfg, y),
        'downsample': study_downsample(cfg, y),
        'istft_iteration': study_istft_iteration(cfg, y),
        'strip_mirror': study_strip_mirror(cfg, y),
        'spec2wavset': study_spec2wavset(cfg, y),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--wav', default=None)
    args = p.parse_args(argv)
    cfg = AudioConfig()
    y = F.load_wav(args.wav, cfg) if args.wav else _test_signal(cfg)
    print(json.dumps(run_all(cfg, y), indent=2))


if __name__ == '__main__':
    main()
