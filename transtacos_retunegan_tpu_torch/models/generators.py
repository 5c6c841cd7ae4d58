"""RetuneGAN generators, ported from
``transtacos_retunegan_tpu/models/generators.py``.

Only the default variant, ``RefineGAN_small``, is ported so far;
``make_generator`` raises ``NotImplementedError`` for the other 11.  The
public call keeps the JAX layout: ``(mel [B, T, n_mel], tmpl [B, S, 1]) ->
wav [B, S, 1]`` with S = T * hop; the convs inside run on ``[B, C, T]``.
Child names equal the flax auto-names (``WNConv_0``, ``WNConvTranspose_2``,
``enc_rs_1``, ...), so flax param paths map onto state-dict keys.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from .vocoder_layers import (LearnedGaussianNoise, ResBlock3, ResidualStack,
                             WNConv, WNConvTranspose, lrelu)


class GeneratorRefineGANSmall(nn.Module):
    """Template encoder (16 -> 32 -> 64 -> 128 with MelGAN residual
    stacks), conv_fuse bottleneck [n_mel + 128 -> C0], transposed-conv
    decoder with skip merges and a 9-3-1 ResBlock3 MRF."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        self.cfg = cfg
        ch = 32
        self.noise = LearnedGaussianNoise()
        self.WNConv_0 = WNConv(1, ch // 2, 7)
        cin = ch // 2
        down = list(zip(hv.upsample_rates[::-1], hv.upsample_kernel_sizes[::-1]))
        self.skip_ch = []
        for i, (u, k) in enumerate(down):
            cout = ch * 2 ** (i + 1) // 2
            self.skip_ch.append(cin)
            self.add_module(f'WNConv_{i + 1}',
                            WNConv(cin, cout, k, stride=u, padding=k // 2))
            self.add_module(f'enc_rs_{i}', ResidualStack(cout))
            cin = cout
        c0 = hv.upsample_initial_channel
        self.conv_fuse = WNConv(cfg.audio.n_mel + cin, c0, 7)
        merge_ch = (128, 64, 32)
        n_layer = len(hv.upsample_rates)
        cin = c0
        for i, (u, k) in enumerate(zip(hv.upsample_rates,
                                       hv.upsample_kernel_sizes)):
            cout = c0 // (2 ** (i + 1))
            self.add_module(f'WNConvTranspose_{i}', WNConvTranspose(cin, cout, k, u))
            self.add_module(f'merge_{i}', WNConv(
                cout + self.skip_ch[n_layer - i - 1], merge_ch[i], 7))
            for j, rk in enumerate(hv.resblock_kernel_sizes):
                self.add_module(f'dec_rb_{i}_{j}',
                                ResBlock3(merge_ch[i], rk, (9, 3, 1)))
            cin = merge_ch[i]
        self.add_module(f'WNConv_{len(down) + 1}', WNConv(cin, 1, 7))

    def forward(self, mel: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
        hv = self.cfg.vocoder
        m = self._modules
        n_down = len(hv.upsample_rates)
        n_k = len(hv.resblock_kernel_sizes)
        y = m['WNConv_0'](tmpl.transpose(1, 2))
        skips = []
        for i in range(n_down):
            y = lrelu(y)
            skips.append(y)
            y = m[f'enc_rs_{i}'](m[f'WNConv_{i + 1}'](y))
        y = lrelu(y)
        z = m['conv_fuse'](torch.cat([mel.transpose(1, 2), y], 1))
        for i in range(n_down):
            z = m[f'WNConvTranspose_{i}'](lrelu(z))
            z = m[f'merge_{i}'](torch.cat([z, skips[n_down - i - 1]], 1))
            z = self.noise(z)
            zs = 0
            for j in range(n_k):
                zs = zs + m[f'dec_rb_{i}_{j}'](z)
            z = self.noise(zs / n_k)
        z = m[f'WNConv_{n_down + 1}'](lrelu(z))
        return torch.tanh(z).transpose(1, 2)


GENERATORS = {'RefineGAN_small': GeneratorRefineGANSmall}


def make_generator(cfg: Config) -> nn.Module:
    ver = cfg.vocoder.generator_ver
    if ver not in GENERATORS:
        raise NotImplementedError(
            f'generator {ver!r} is not ported yet (only {sorted(GENERATORS)})')
    return GENERATORS[ver](cfg)
