"""RetuneGAN losses, ported from
``transtacos_retunegan_tpu/models/vocoder_losses.py``: multi-resolution
STFT, envelope / dynamic / strip-mirror, LSGAN (or relativistic)
adversarial and feature matching.  Waveforms are ``[B, S]``; the STFT
discriminator's inputs are ``[B, 2, F, T]`` (log-magnitude, phase/pi).
``stop_gradient`` of the JAX package is ``detach()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..audio import dsp
from ..config import Config
from ..parallel import Shard, global_mean

PI = 3.14159265358979


def _log(x: torch.Tensor) -> torch.Tensor:
    # the 1e-12 floor only guards empty mel filters at tiny n_fft
    return torch.log(torch.clamp(x, min=1e-12))


def _spec(log_s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.stack([log_s, p / PI], dim=1)


def multi_stft_specs_and_loss(y: torch.Tensor, y_g: torch.Tensor, cfg: Config
                              ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Per STFT resolution: L1(mel) + L1(log mel), averaged over the
    resolutions; and the MTD inputs of both waveforms.  ``phd_input='phase'``
    pairs the real magnitude with the fake phase."""
    hv = cfg.vocoder
    if hv.phd_input not in ('stft', 'phase'):
        raise ValueError(hv.phd_input)
    loss = 0.0
    specs_r, specs_g = [], []
    for n_fft, win_length, hop_length in hv.multi_stft_params:
        s_r, m_r, p_r = dsp.stft_mag_mel_phase(y, cfg.audio, n_fft, win_length,
                                               hop_length)
        s_g, m_g, p_g = dsp.stft_mag_mel_phase(y_g, cfg.audio, n_fft, win_length,
                                               hop_length)
        log_s_r = _log(s_r)
        specs_r.append(_spec(log_s_r, p_r))
        specs_g.append(_spec(log_s_r if hv.phd_input == 'phase' else _log(s_g), p_g))
        loss = loss + torch.mean(torch.abs(m_r - m_g))
        loss = loss + torch.mean(torch.abs(_log(m_r) - _log(m_g)))
    return loss / len(hv.multi_stft_params), specs_r, specs_g


def multi_stft_specs(y: torch.Tensor, cfg: Config) -> List[torch.Tensor]:
    """MTD inputs of one waveform (the R1 penalty's real branch)."""
    specs = []
    for n_fft, win_length, hop_length in cfg.vocoder.multi_stft_params:
        s, _, p = dsp.stft_mag_mel_phase(y, cfg.audio, n_fft, win_length, hop_length)
        specs.append(_spec(_log(s), p))
    return specs


def _max_pool(y: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool1d(k) with stride k, no padding, as trim + reshape + max."""
    n = y.shape[-1] // k
    return y[..., :n * k].reshape(y.shape[:-1] + (n, k)).amax(-1)


def envelope_loss(y: torch.Tensor, y_g: torch.Tensor, cfg: Config) -> torch.Tensor:
    k = cfg.vocoder.envelope_pool_k
    return (torch.mean(torch.abs(_max_pool(y, k) - _max_pool(y_g, k)))
            + torch.mean(torch.abs(_max_pool(-y, k) - _max_pool(-y_g, k))))


def dynamic_loss(y: torch.Tensor, y_g: torch.Tensor, cfg: Config) -> torch.Tensor:
    k = cfg.vocoder.envelope_pool_k
    dyn_r = torch.abs(_max_pool(y, k) + _max_pool(-y, k))
    dyn_g = torch.abs(_max_pool(y_g, k) + _max_pool(-y_g, k))
    return torch.mean(torch.abs(dyn_r - dyn_g))


def strip_mirror_loss(y: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """-log of the de-meaned even/odd sample difference (clipped at 1); the
    means are the global batch's under a data-parallel ``shard``."""
    if y.shape[-1] % 2:
        y = y[..., :-1]
    even, odd = y[..., ::2], y[..., 1::2]
    even = even - global_mean(even, shard)
    odd = odd - global_mean(odd, shard)
    return torch.mean(-torch.log(torch.clamp(torch.abs(even - odd) + 1e-9, max=1.0)))


def discriminator_loss(disc_r: Sequence[torch.Tensor], disc_g: Sequence[torch.Tensor],
                       cfg: Config) -> torch.Tensor:
    """LSGAN (or relativistic) D loss summed over the towers; ``disc_g``
    comes from a detached fake."""
    loss = 0.0
    for dr, dg in zip(disc_r, disc_g):
        if cfg.vocoder.relative_gan_loss:
            r_loss = torch.mean(torch.mean((1.0 - (dr - dg.detach())) ** 2, dim=-1))
        else:
            r_loss = torch.mean(torch.mean((1.0 - dr) ** 2, dim=-1))
        g_loss = torch.mean(torch.mean((0.0 - dg) ** 2, dim=-1))
        loss = loss + r_loss + g_loss
    return loss


def generator_loss(disc_g: Sequence[torch.Tensor], disc_r: Sequence[torch.Tensor],
                   cfg: Config) -> torch.Tensor:
    """LSGAN (or relativistic) G adversarial loss."""
    loss = 0.0
    for dg, dr in zip(disc_g, disc_r):
        if cfg.vocoder.relative_gan_loss:
            loss = loss + torch.mean(torch.mean((dg - dr.detach()) ** 2, dim=-1))
        else:
            loss = loss + torch.mean(torch.mean((1.0 - dg) ** 2, dim=-1))
    return loss


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 over all feature-map pairs."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for r, g in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss
