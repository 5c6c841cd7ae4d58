"""RetuneGAN discriminators, ported from
``transtacos_retunegan_tpu/models/discriminators.py``: multi-scale (MSD),
multi-period (MPD) and multi-STFT (MTD).

Layouts are torch's: waveforms enter as ``[B, 1, S]``, STFT images as
``[B, 2, F, T]`` (log-magnitude, phase/pi channels).  Each tower returns
(score ``[B, K]``, feature maps), K in the JAX package's order; feature
maps are ``[B, C, ...]``.  A multi-discriminator returns ``(real scores,
fake scores, real fmaps, fake fmaps)``; without a fake input it runs the
real branch only and returns empty fake lists (the R1 penalty's path).
Real and fake run through each tower as one batch.

``Discriminators`` holds the three as ``msd``/``mpd``/``mtd``, the keys of
the JAX package's ``disc_params`` tree.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from .vocoder_layers import WNConv, WNConv2d, lrelu


def _scale_ch(ch: int, mult: float, groups: int = 1) -> Tuple[int, int]:
    """Scale (features, groups) by a width multiplier, keeping features a
    multiple of groups (the JAX package's rule: 1.0 is the identity,
    widening scales features only)."""
    if mult == 1.0:
        return ch, groups
    if mult > 1.0:
        f = int(round(ch * mult))
        return -(-f // max(groups, 1)) * max(groups, 1), groups
    g = max(1, int(round(groups * mult)))
    f = max(g, int(round(ch * mult)))
    f = -(-f // g) * g
    return f, g


class _Tower(nn.Module):
    """conv_0 .. conv_{n-1}, each output a feature map then leaky_relu, and
    conv_post flattened to the score."""

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for i in range(self.n_conv):
            x = self._modules[f'conv_{i}'](x)
            fmap.append(x)
            x = lrelu(x)
        return self.conv_post(x).flatten(1), fmap


class DiscriminatorS(_Tower):
    """MelGAN-small grouped-conv scale discriminator on ``[B, 1, S]``."""

    SPECS = ((32, 15, 1, 7, 1), (64, 41, 2, 20, 4), (128, 41, 2, 20, 8),
             (512, 41, 4, 20, 32), (512, 41, 4, 20, 64), (512, 5, 1, 2, 1))

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.n_conv = len(self.SPECS)
        cin = 1
        for i, (f, k, s, p, g) in enumerate(self.SPECS):
            f, g = _scale_ch(f, width_mult, g)
            self.add_module(f'conv_{i}', WNConv(cin, f, k, stride=s, groups=g, padding=p))
            cin = f
        self.conv_post = WNConv(cin, 1, 3, padding=1)


class DiscriminatorP(_Tower):
    """Period-folded 2D discriminator: ``[B, 1, S]`` reflect-padded to a
    multiple of the period and folded to ``[B, 1, S/p, p]``."""

    def __init__(self, period: int, width_mult: float = 1.0):
        super().__init__()
        self.period = period
        self.n_conv = 5
        cin = 1
        for i, ch in enumerate((32, 128, 256, 512)):
            ch = _scale_ch(ch, width_mult)[0]
            self.add_module(f'conv_{i}', WNConv2d(cin, ch, (5, 1), (3, 1), (2, 0)))
            cin = ch
        ch = _scale_ch(512, width_mult)[0]
        self.conv_4 = WNConv2d(cin, ch, (5, 1), (1, 1), (2, 0))
        self.conv_post = WNConv2d(ch, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x):
        b, c, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x, (0, p - t % p), mode='reflect')
        return super().forward(x.view(b, c, -1, p))


class StftDiscriminator(_Tower):
    """2-channel (log-magnitude, phase/pi) spectrogram discriminator on
    ``[B, 2, F, T]``."""

    SPECS = ((32, (3, 3), (2, 1), (1, 1)), (64, (3, 3), (2, 2), (1, 1)),
             (256, (5, 3), (3, 2), (2, 1)), (512, (5, 3), (3, 2), (2, 1)),
             (512, (3, 3), (1, 1), (1, 1)))

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.n_conv = len(self.SPECS)
        cin = 2
        for i, (f, k, s, p) in enumerate(self.SPECS):
            f = _scale_ch(f, width_mult)[0]
            self.add_module(f'conv_{i}', WNConv2d(cin, f, k, s, p))
            cin = f
        self.conv_post = WNConv2d(cin, 1, (3, 3), (1, 1), (1, 1))


def _both(d: nn.Module, x: torch.Tensor, x_hat: Optional[torch.Tensor]):
    """One tower on the real input and, when given, the fake one (as one
    batch): (score_r, score_g, fmap_r, fmap_g), the fake ones None
    without a fake input."""
    if x_hat is None:
        s, f = d(x)
        return s, None, f, None
    b = x.shape[0]
    s, f = d(torch.cat([x, x_hat]))
    return s[:b], s[b:], [m[:b] for m in f], [m[b:] for m in f]


def _collect(results):
    rs, gs, fr, fg = [], [], [], []
    for sr, sg, fmr, fmg in results:
        rs.append(sr)
        fr.append(fmr)
        if sg is not None:
            gs.append(sg)
            fg.append(fmg)
    return rs, gs, fr, fg


class MultiScaleDiscriminator(nn.Module):
    """``msd_layers`` scales with average pooling (kernel
    ``downsample_pool_k``, stride 2, padding 1, zero padding counted)
    between them."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        self.pool_k = hv.downsample_pool_k
        for i in range(hv.msd_layers):
            self.add_module(f'disc_{i}', DiscriminatorS(hv.disc_width_mult))

    def forward(self, y: torch.Tensor, y_hat: Optional[torch.Tensor] = None):
        out = []
        discs = list(self.children())
        for i, d in enumerate(discs):
            out.append(_both(d, y, y_hat))
            if i != len(discs) - 1:
                y = F.avg_pool1d(y, self.pool_k, 2, 1, count_include_pad=True)
                if y_hat is not None:
                    y_hat = F.avg_pool1d(y_hat, self.pool_k, 2, 1,
                                         count_include_pad=True)
        return _collect(out)


class MultiPeriodDiscriminator(nn.Module):
    """One ``DiscriminatorP`` per period of ``mpd_periods``."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        for p in hv.mpd_periods:
            self.add_module(f'disc_p{p}', DiscriminatorP(p, hv.disc_width_mult))

    def forward(self, y: torch.Tensor, y_hat: Optional[torch.Tensor] = None):
        return _collect(_both(d, y, y_hat) for d in self.children())


class MultiStftDiscriminator(nn.Module):
    """One ``StftDiscriminator`` per STFT resolution."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        for i in range(len(hv.multi_stft_params)):
            self.add_module(f'disc_{i}', StftDiscriminator(hv.disc_width_mult))

    def forward(self, specs_r: Sequence[torch.Tensor],
                specs_g: Optional[Sequence[torch.Tensor]] = None):
        return _collect(_both(d, sr, None if specs_g is None else specs_g[i])
                        for i, (d, sr) in enumerate(zip(self.children(), specs_r)))


class Discriminators(nn.Module):
    """MSD, MPD and MTD together, named as the JAX package's
    ``disc_params`` keys."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.msd = MultiScaleDiscriminator(cfg)
        self.mpd = MultiPeriodDiscriminator(cfg)
        self.mtd = MultiStftDiscriminator(cfg)
