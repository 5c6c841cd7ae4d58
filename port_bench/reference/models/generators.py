"""RetuneGAN generators (all 12 variants), ported from
``transtacos_retunegan_tpu/models/generators.py``.

The public call keeps the JAX layout: ``(mel [B, T, n_mel], tmpl [B, S, 1])
-> wav [B, S, 1]`` with S = T * hop; the Split variants take ``(mel_c,
mel_v, tmpl_c, tmpl_v, uv [B, S, 1])``.  The convs inside run on ``[B, C,
T]``.  Child names equal the flax auto-names (``WNConv_0``,
``ResidualBlock_1``, ``x_rb_0_2``, ``alpha``, ...), so flax param paths map
onto state-dict keys.

``noise`` is the training noise of the RefineGAN variants (see
``vocoder_layers``): None is the inference forward; the other variants
have no noise and ignore it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from .vocoder_layers import (LearnedGaussianNoise, ResBlock2, ResBlock3,
                             ResBlockFull, ResidualBlock, ResidualStack,
                             WNConv, WNConvTranspose, lrelu, noise_source)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, C] <-> [B, C, T]``."""
    return x.transpose(1, 2)


def _post(x: torch.Tensor, conv: nn.Module, slope: float = 0.01) -> torch.Tensor:
    """leaky_relu -> conv -> tanh, back to ``[B, S, 1]``."""
    return _cl(torch.tanh(conv(F.leaky_relu(x, slope))))


def _mrf(blocks, x: torch.Tensor) -> torch.Tensor:
    """Multi-receptive-field fusion: the mean of the blocks' outputs."""
    return sum(b(x) for b in blocks) / len(blocks)


class GeneratorRetuneCNN(nn.Module):
    """Wave-to-wave CNN on the Griffin-Lim template; ignores mel."""

    def __init__(self, cfg: Config):
        super().__init__()
        chans = (32, 128, 128, 128, 128, 128, 32)
        self.WNConv_0 = WNConv(1, 32, 15)
        for i in range(6):
            self.add_module(f'WNConv_{i + 1}', WNConv(chans[i], chans[i + 1], 41))
        self.WNConv_7 = WNConv(32, 1, 7)

    def forward(self, mel, tmpl, noise=None):
        y = self.WNConv_0(_cl(tmpl))
        for i in range(1, 8):
            y = self._modules[f'WNConv_{i}'](torch.tanh(y))
        return _cl(torch.tanh(y))


class GeneratorMelGAN(nn.Module):
    """Classic MelGAN n_mel -> 512 -> ... -> 32 -> 1 transposed-conv stack."""

    def __init__(self, cfg: Config, use_post: bool = True):
        super().__init__()
        self.use_post = use_post
        self.WNConv_0 = WNConv(cfg.audio.n_mel, 512, 7)
        cin = 512
        for i, (cout, k, s) in enumerate(((256, 16, 8), (128, 16, 8), (64, 4, 2),
                                          (32, 4, 2))):
            self.add_module(f'ResidualBlock_{i}', ResidualBlock(cin, cout, k, s))
            cin = cout
        if use_post:
            self.WNConv_1 = WNConv(32, 1, 7)

    def body(self, mel: torch.Tensor) -> torch.Tensor:
        """``[B, T, n_mel] -> [B, 32, S]`` (no post conv)."""
        x = self.WNConv_0(_cl(mel))
        for i in range(4):
            x = self._modules[f'ResidualBlock_{i}'](x)
        return x

    def forward(self, mel, tmpl=None, noise=None):
        return _post(self.body(mel), self.WNConv_1)


class GeneratorMelGANRetune(nn.Module):
    """Dual branch: mel upsampled by 64, template downsampled by 4, concat
    with a learnable scale alpha (4 at init), joint decode."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.WNConv_0 = WNConv(cfg.audio.n_mel, 256, 7)
        self.ResidualBlock_0 = ResidualBlock(256, 128, 16, 8)
        self.ResidualBlock_1 = ResidualBlock(128, 64, 16, 8)
        self.WNConv_1 = WNConv(1, 16, 7)
        self.ResidualBlock_2 = ResidualBlock(16, 32, 4, 2, resize='d')
        self.ResidualBlock_3 = ResidualBlock(32, 64, 4, 2, resize='d')
        self.alpha = nn.Parameter(torch.full((1,), 4.0))
        self.ResidualBlock_4 = ResidualBlock(128, 64, 4, 2)
        self.ResidualBlock_5 = ResidualBlock(64, 32, 4, 2)
        self.WNConv_2 = WNConv(32, 1, 7)

    def forward(self, mel, tmpl, noise=None):
        x = self.ResidualBlock_1(self.ResidualBlock_0(self.WNConv_0(_cl(mel))))
        y = self.ResidualBlock_3(self.ResidualBlock_2(self.WNConv_1(_cl(tmpl))))
        z = torch.cat([x, y * self.alpha], 1)
        z = self.ResidualBlock_5(self.ResidualBlock_4(z))
        return _post(z, self.WNConv_2, 0.15)


class GeneratorMelGANSplit(nn.Module):
    """Two post-less MelGANs for the consonant/vowel bands, mixed by the u/v
    mask, then a refine stack."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.g_c = GeneratorMelGAN(cfg, use_post=False)
        self.g_v = GeneratorMelGAN(cfg, use_post=False)
        self.WNConv_0 = WNConv(32, 32, 7)
        self.ResidualStack_0 = ResidualStack(32)
        self.WNConv_1 = WNConv(32, 1, 7)

    def forward(self, mel_c, mel_v, tmpl_c, tmpl_v, uv, noise=None):
        uv = _cl(uv)
        z = self.g_c.body(mel_c) * uv + self.g_v.body(mel_v) * (1.0 - uv)
        z = self.ResidualStack_0(self.WNConv_0(z))
        return _post(z, self.WNConv_1, 0.15)


class _HiFiGANBase(nn.Module):
    """WNConv_0 prenet and one ``WNConvTranspose_i`` per upsample stage,
    C0 / 2^(i+1) channels; subclasses add the per-stage blocks."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        c0 = hv.upsample_initial_channel
        self.WNConv_0 = WNConv(cfg.audio.n_mel, c0, 7)
        self.stage_ch = []
        cin = c0
        for i, (u, k) in enumerate(zip(hv.upsample_rates, hv.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.add_module(f'WNConvTranspose_{i}', WNConvTranspose(cin, ch, k, u))
            self.stage_ch.append(ch)
            cin = ch

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return x

    def body(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.WNConv_0(_cl(mel))
        for i in range(len(self.stage_ch)):
            x = self.stage(i, self._modules[f'WNConvTranspose_{i}'](lrelu(x)))
        return x


class GeneratorHiFiGAN(_HiFiGANBase):
    """Standard HiFiGAN MRF generator (ResBlock2 per kernel size)."""

    def __init__(self, cfg: Config, use_post: bool = True):
        super().__init__(cfg)
        hv = cfg.vocoder
        self.n_k = len(hv.resblock_kernel_sizes)
        for i, ch in enumerate(self.stage_ch):
            for j, (rk, rd) in enumerate(zip(hv.resblock_kernel_sizes,
                                             hv.resblock_dilation_sizes)):
                self.add_module(f'resblock_{i}_{j}', ResBlock2(ch, rk, rd))
        if use_post:
            self.WNConv_1 = WNConv(self.stage_ch[-1], 1, 7)

    def stage(self, i, x):
        return _mrf([self._modules[f'resblock_{i}_{j}'] for j in range(self.n_k)], x)

    def forward(self, mel, tmpl=None, noise=None):
        return _post(self.body(mel), self.WNConv_1)


class GeneratorHiFiGANMini(_HiFiGANBase):
    """HiFiGAN with a single ResBlockFull (dilations 1-3-9) per stage."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        for i, ch in enumerate(self.stage_ch):
            self.add_module(f'ResBlockFull_{i}', ResBlockFull(ch, 3, (1, 3, 9)))
        self.WNConv_1 = WNConv(self.stage_ch[-1], 1, 7)

    def stage(self, i, x):
        return self._modules[f'ResBlockFull_{i}'](x)

    def forward(self, mel, tmpl=None, noise=None):
        return _post(self.body(mel), self.WNConv_1)


class GeneratorHiFiGANMicro(_HiFiGANBase):
    """HiFiGAN with one 41-tap conv per stage."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        n = len(self.stage_ch)
        for i, ch in enumerate(self.stage_ch):
            self.add_module(f'WNConv_{i + 1}', WNConv(ch, ch, 41))
        self.add_module(f'WNConv_{n + 1}', WNConv(self.stage_ch[-1], 1, 7))

    def stage(self, i, x):
        return self._modules[f'WNConv_{i + 1}'](x)

    def forward(self, mel, tmpl=None, noise=None):
        return _post(self.body(mel), self._modules[f'WNConv_{len(self.stage_ch) + 1}'])


class GeneratorHiFiGANMu(_HiFiGANBase):
    """Upsample-only ablation, no resblocks."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.WNConv_1 = WNConv(self.stage_ch[-1], 1, 7)

    def forward(self, mel, tmpl=None, noise=None):
        return _post(self.body(mel), self.WNConv_1)


class GeneratorRefineGAN(nn.Module):
    """RefineGAN UNet: template encoder 32 -> 256 with ResBlock2, mel prenet
    concatenated at the bottleneck, transposed-conv decoder with skip
    merges, a 3-kernel ResBlock2 MRF and two noise injections per stage
    (one shared ``noise`` module, one ``w``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        self.n_k = len(hv.resblock_kernel_sizes)
        ch, c0 = 32, hv.upsample_initial_channel
        n = len(hv.upsample_rates)
        self.n = n
        self.noise = LearnedGaussianNoise()
        self.WNConv_0 = WNConv(1, ch, 7)
        skip_ch = []
        down = list(zip(hv.upsample_rates[::-1], hv.upsample_kernel_sizes[::-1]))
        for i, (u, k) in enumerate(down):
            skip_ch.append(ch * 2 ** i)
            cout = ch * 2 ** (i + 1)
            self.add_module(f'WNConv_{i + 1}',
                            WNConv(ch * 2 ** i, cout, k, stride=u, padding=k // 2))
            self.add_module(f'enc_rb_{i}', ResBlock2(cout, 5, (1, 3)))
        self.add_module(f'WNConv_{n + 1}', WNConv(cfg.audio.n_mel, c0, 7))
        cin = c0 + ch * 2 ** n
        merge_ch = (256, 128, 64)
        for i, (u, k) in enumerate(zip(hv.upsample_rates, hv.upsample_kernel_sizes)):
            cout = c0 // (2 ** (i + 1)) * 2
            self.add_module(f'WNConvTranspose_{i}', WNConvTranspose(cin, cout, k, u))
            self.add_module(f'merge_{i}',
                            WNConv(cout + skip_ch[n - i - 1], merge_ch[i], 7))
            for j, (rk, rd) in enumerate(zip(hv.resblock_kernel_sizes,
                                             hv.resblock_dilation_sizes)):
                self.add_module(f'dec_rb_{i}_{j}', ResBlock2(merge_ch[i], rk, rd))
            cin = merge_ch[i]
        self.add_module(f'WNConv_{n + 2}', WNConv(cin, 1, 7))

    def forward(self, mel, tmpl, noise=None):
        m, n = self._modules, self.n
        noise = noise_source(noise)
        y = self.WNConv_0(_cl(tmpl))
        skips = []
        for i in range(n):
            y = lrelu(y)
            skips.append(y)
            y = m[f'enc_rb_{i}'](m[f'WNConv_{i + 1}'](y))
        z = torch.cat([m[f'WNConv_{n + 1}'](_cl(mel)), y], 1)
        for i in range(n):
            z = m[f'WNConvTranspose_{i}'](lrelu(z))
            z = m[f'merge_{i}'](torch.cat([z, skips[n - i - 1]], 1))
            z = self.noise(z, noise)
            z = self.noise(_mrf([m[f'dec_rb_{i}_{j}'] for j in range(self.n_k)], z),
                           noise)
        return _post(z, m[f'WNConv_{n + 2}'], 0.15)


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

    def forward(self, mel: torch.Tensor, tmpl: torch.Tensor, noise=None) -> torch.Tensor:
        hv = self.cfg.vocoder
        m = self._modules
        noise = noise_source(noise)
        n_down = len(hv.upsample_rates)
        n_k = len(hv.resblock_kernel_sizes)
        y = m['WNConv_0'](_cl(tmpl))
        skips = []
        for i in range(n_down):
            y = lrelu(y)
            skips.append(y)
            y = m[f'enc_rs_{i}'](m[f'WNConv_{i + 1}'](y))
        y = lrelu(y)
        z = m['conv_fuse'](torch.cat([_cl(mel), y], 1))
        for i in range(n_down):
            z = m[f'WNConvTranspose_{i}'](lrelu(z))
            z = m[f'merge_{i}'](torch.cat([z, skips[n_down - i - 1]], 1))
            z = self.noise(z, noise)
            z = self.noise(_mrf([m[f'dec_rb_{i}_{j}'] for j in range(n_k)], z), noise)
        return _post(z, m[f'WNConv_{n_down + 1}'], 0.15)


class GeneratorHiFiGANRetune(nn.Module):
    """HiFiGAN fusing the template halfway: mel x64 by two (16, 8)
    transposed convs, template /4 by two strided convs, concat with alpha,
    then two (4, 2) transposed convs."""

    def __init__(self, cfg: Config):
        super().__init__()
        hv = cfg.vocoder
        rks, rds = hv.resblock_kernel_sizes, hv.resblock_dilation_sizes
        self.n_k = len(rks)
        self.WNConv_0 = WNConv(cfg.audio.n_mel, 256, 7)
        self.WNConv_1 = WNConv(1, 16, 7)
        cin = 256
        for i, ch in enumerate((128, 64)):
            self.add_module(f'WNConvTranspose_{i}',
                            WNConvTranspose(cin, ch, 16, 8, padding=4, output_padding=0))
            for j, (rk, rd) in enumerate(zip(rks, rds)):
                self.add_module(f'x_rb_{i}_{j}', ResBlock2(ch, rk, rd))
            cin = ch
        cin = 16
        for i, ch in enumerate((32, 64)):
            self.add_module(f'WNConv_{i + 2}', WNConv(cin, ch, 4, stride=2, padding=1))
            self.add_module(f'y_rb_{i}', ResBlockFull(ch, 3, (1, 3, 9)))
            cin = ch
        self.alpha = nn.Parameter(torch.full((1,), 4.0))
        cin = 128
        for i, ch in enumerate((64, 32)):
            self.add_module(f'WNConvTranspose_{i + 2}',
                            WNConvTranspose(cin, ch, 4, 2, padding=1, output_padding=0))
            for j, (rk, rd) in enumerate(zip(rks, rds)):
                self.add_module(f'z_rb_{i}_{j}', ResBlock2(ch, rk, rd))
            cin = ch
        self.WNConv_4 = WNConv(32, 1, 7)

    def forward(self, mel, tmpl, noise=None):
        m = self._modules
        x = self.WNConv_0(_cl(mel))
        for i in range(2):
            x = m[f'WNConvTranspose_{i}'](lrelu(x))
            x = _mrf([m[f'x_rb_{i}_{j}'] for j in range(self.n_k)], x)
        y = self.WNConv_1(_cl(tmpl))
        for i in range(2):
            y = m[f'y_rb_{i}'](m[f'WNConv_{i + 2}'](lrelu(y)))
        z = torch.cat([x, y * self.alpha], 1)
        for i in range(2):
            z = m[f'WNConvTranspose_{i + 2}'](lrelu(z))
            z = _mrf([m[f'z_rb_{i}_{j}'] for j in range(self.n_k)], z)
        return _post(z, self.WNConv_4)


class GeneratorHiFiGANSplit(nn.Module):
    """Two post-less HiFiGANs mixed by the u/v mask, then a refine conv."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.g_c = GeneratorHiFiGAN(cfg, use_post=False)
        self.g_v = GeneratorHiFiGAN(cfg, use_post=False)
        self.WNConv_0 = WNConv(self.g_c.stage_ch[-1], 32, 7)
        self.WNConv_1 = WNConv(32, 1, 15)

    def forward(self, mel_c, mel_v, tmpl_c, tmpl_v, uv, noise=None):
        uv = _cl(uv)
        z = self.g_c.body(mel_c) * uv + self.g_v.body(mel_v) * (1.0 - uv)
        return _post(self.WNConv_0(z), self.WNConv_1, 0.15)


GENERATORS = {
    'RetuneCNN': GeneratorRetuneCNN,
    'MelGAN': GeneratorMelGAN,
    'MelGANRetune': GeneratorMelGANRetune,
    'MelGANSplit': GeneratorMelGANSplit,
    'HiFiGAN': GeneratorHiFiGAN,
    'HiFiGAN_mini': GeneratorHiFiGANMini,
    'HiFiGAN_micro': GeneratorHiFiGANMicro,
    'HiFiGAN_mu': GeneratorHiFiGANMu,
    'RefineGAN': GeneratorRefineGAN,
    'RefineGAN_small': GeneratorRefineGANSmall,
    'HiFiGANRetune': GeneratorHiFiGANRetune,
    'HiFiGANSplit': GeneratorHiFiGANSplit,
}


def make_generator(cfg: Config) -> nn.Module:
    ver = cfg.vocoder.generator_ver
    if ver not in GENERATORS:
        raise ValueError(f'unknown generator {ver!r} (one of {sorted(GENERATORS)})')
    return GENERATORS[ver](cfg)
