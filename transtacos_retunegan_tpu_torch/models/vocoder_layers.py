"""Vocoder building blocks at inference, ported from
``transtacos_retunegan_tpu/models/vocoder_layers.py``.

Convs run in torch's ``[B, C, T]`` layout.  Weight normalisation is the JAX
package's: ``w = g * v / sqrt(sum(v^2) + 1e-12)`` with the norm taken per
OUTPUT channel, for plain and transposed convs alike (torch's
``weight_norm`` on ConvTranspose1d would group per input channel).  Grouped
convs use ``F.conv1d(groups=...)`` directly.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.15


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _wn(v: torch.Tensor, g: torch.Tensor, dims) -> torch.Tensor:
    shape = [1] * v.ndim
    out_dim = ({0, 1, 2} - set(dims)).pop()
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
        w = _wn(self.v, self.g, (1, 2))
        return F.conv1d(x, w, self.b, self.stride, self.padding,
                        self.dilation, self.groups)


class WNConvTranspose(nn.Module):
    """Weight-normalised ConvTranspose1d; v ``[in, out, k]``; torch padding
    ``k // 2`` and output padding ``stride - 1`` unless given (an exact
    ``stride x`` upsampler for odd k)."""

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
        w = _wn(self.v, self.g, (0, 2))
        return F.conv_transpose1d(x, w, self.b, self.stride, self.padding,
                                  self.output_padding)


class LearnedGaussianNoise(nn.Module):
    """Learned-scale uniform noise + leaky_relu; at inference only the
    leaky_relu remains (``w`` is kept for the param tree)."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.full((1,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class ResBlock3(nn.Module):
    """3-conv dilated resblock: x += conv_d(lrelu(x)) per dilation."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        for i, d in enumerate(dilation):
            self.add_module(f'WNConv_{i}',
                            WNConv(channels, channels, kernel, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = conv(lrelu(x)) + x
        return x
