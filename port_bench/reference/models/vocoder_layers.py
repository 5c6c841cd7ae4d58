"""Vocoder building blocks, ported from
``transtacos_retunegan_tpu/models/vocoder_layers.py``.

Convs run in torch's ``[B, C, T]`` (``[B, C, H, W]`` in 2D) layout.  Weight
normalisation is the JAX package's: ``w = g * v / sqrt(sum(v^2) + 1e-12)``
with the norm taken per OUTPUT channel, for plain, transposed and 2D convs
alike (torch's ``weight_norm`` on ConvTranspose1d would group per input
channel).  Grouped convs use ``groups=`` directly (the JAX package's
block-diagonal dense lowering is a TPU workaround with the same result).

Training noise (``LearnedGaussianNoise``) comes from an explicit source: a
``torch.Generator`` on the tensor's device, or an iterator of tensors the
caller drew (``noise_source`` turns a list into one).  ``None`` is the
inference forward.  A callable ``draw(shape, device)`` is a third source:
the GAN step's data-parallel draw of the global batch's shape, of which
this rank keeps its rows.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.15

Noise = Union[None, torch.Generator, Iterator[torch.Tensor],
              Callable[[Tuple[int, ...], torch.device], torch.Tensor]]


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def noise_source(noise) -> Noise:
    """A list or tuple of noise tensors becomes an iterator consumed in the
    order of the noise calls; a ``torch.Generator``, an iterator, a draw
    callable or None passes through."""
    return iter(noise) if isinstance(noise, (list, tuple)) else noise


def _wn(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    dims = tuple(d for d in range(v.ndim) if d != out_dim)
    shape = [1] * v.ndim
    shape[out_dim] = -1
    norm = torch.sqrt((v * v).sum(dim=dims, keepdim=True) + 1e-12)
    return v * (g.reshape(shape) / norm)


class WNConv(nn.Module):
    """Weight-normalised Conv1d; v ``[out, in/groups, k]``, symmetric pad
    ``dilation * (k // 2)`` unless given."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, padding: int = -1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = padding if padding >= 0 else dilation * (kernel // 2)
        self.v = nn.Parameter(torch.zeros(cout, cin // groups, kernel))
        self.g = nn.Parameter(torch.ones(cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, _wn(self.v, self.g, 0), self.b, self.stride,
                        self.padding, self.dilation, self.groups)


class WNConvTranspose(nn.Module):
    """Weight-normalised ConvTranspose1d; v ``[in, out, k]``; torch padding
    ``k // 2`` and output padding ``stride - 1`` unless given (an exact
    ``stride x`` upsampler for odd k; the even kernels of the MelGAN and
    HiFiGANRetune blocks pass ``padding`` and ``output_padding=0``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int = -1, output_padding: int = -1):
        super().__init__()
        self.stride = stride
        self.padding = padding if padding >= 0 else kernel // 2
        self.output_padding = output_padding if output_padding >= 0 else stride - 1
        self.v = nn.Parameter(torch.zeros(cin, cout, kernel))
        self.g = nn.Parameter(torch.ones(cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, _wn(self.v, self.g, 1), self.b, self.stride,
                                  self.padding, self.output_padding)


class WNConv2d(nn.Module):
    """Weight-normalised Conv2d; v ``[out, in, kh, kw]``, the norm per
    output channel over (in, kh, kw); symmetric padding per axis."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.v = nn.Parameter(torch.zeros(cout, cin, *kernel))
        self.g = nn.Parameter(torch.ones(cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, _wn(self.v, self.g, 0), self.b, self.stride, self.padding)


class LearnedGaussianNoise(nn.Module):
    """``x + U[0,1) * w`` then leaky_relu (uniform noise despite the name,
    as in the reference).  ``noise`` None is the inference forward: only
    the leaky_relu."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.full((1,), 1e-6))

    def forward(self, x: torch.Tensor, noise: Noise = None) -> torch.Tensor:
        if noise is not None:
            if isinstance(noise, torch.Generator):
                n = torch.rand(x.shape, generator=noise, device=x.device)
            elif callable(noise):
                n = noise(tuple(x.shape), x.device)
            else:
                n = next(noise)
            x = x + n.to(x.dtype) * self.w
        return lrelu(x)


class ResidualStack(nn.Module):
    """MelGAN residual stack: 3 units of (lrelu-conv(dilated)-lrelu-conv),
    dilations 1/3/9, torch-default leaky slope 0.01."""

    def __init__(self, channels: int):
        super().__init__()
        convs = []
        for d in (1, 3, 9):
            convs += [WNConv(channels, channels, 3, dilation=d),
                      WNConv(channels, channels, 3)]
        for i, c in enumerate(convs):
            self.add_module(f'WNConv_{i}', c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.children())
        for c1, c2 in zip(convs[0::2], convs[1::2]):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, 0.01)), 0.01))
        return x


class ResidualBlock(nn.Module):
    """MelGAN up/down block: lrelu -> resize conv -> ResidualStack.  'u'
    is a transposed conv with padding ``stride // 2`` and no output
    padding (exactly ``stride x`` for the (16, 8) and (4, 2) pairs); 'd' a
    strided conv with the same padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 resize: str = 'u'):
        super().__init__()
        self.resize = resize
        if resize == 'u':
            self.WNConvTranspose_0 = WNConvTranspose(cin, cout, kernel, stride,
                                                     padding=stride // 2,
                                                     output_padding=0)
        else:
            self.WNConv_0 = WNConv(cin, cout, kernel, stride=stride,
                                   padding=stride // 2)
        self.ResidualStack_0 = ResidualStack(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.WNConvTranspose_0 if self.resize == 'u' else self.WNConv_0
        return self.ResidualStack_0(conv(lrelu(x)))


class _DilatedBlock(nn.Module):
    """x += conv_d(lrelu(x)) per dilation (ResBlock2 / ResBlock3)."""

    def __init__(self, channels: int, kernel: int, dilation: Sequence[int]):
        super().__init__()
        for i, d in enumerate(dilation):
            self.add_module(f'WNConv_{i}',
                            WNConv(channels, channels, kernel, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(lrelu(x)) + x
        return x


class ResBlock2(_DilatedBlock):
    """HiFiGAN 2-conv dilated resblock."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__(channels, kernel, dilation)


class ResBlock3(_DilatedBlock):
    """3-conv dilated resblock."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__(channels, kernel, dilation)


class ResBlockFull(nn.Module):
    """HiFiGAN-v1 style resblock: per dilation, x += conv_1(lrelu(conv_d(lrelu(x))))."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        for i, d in enumerate(dilation):
            self.add_module(f'WNConv_{2 * i}',
                            WNConv(channels, channels, kernel, dilation=d))
            self.add_module(f'WNConv_{2 * i + 1}', WNConv(channels, channels, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = list(self.children())
        for c1, c2 in zip(convs[0::2], convs[1::2]):
            x = c2(lrelu(c1(lrelu(x)))) + x
        return x

